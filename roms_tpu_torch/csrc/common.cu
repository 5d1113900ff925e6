// Error strings for the ctypes wrappers (ops/_lib.py): every kernel
// entry point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>

extern "C" const char* roms_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

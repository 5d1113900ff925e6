"""Physical constants for the TPU ocean dynamical core.

Values match the reference model's defaults (ROMS/Modules/mod_scalars.F:456-787)
so that idealized test cases are directly comparable.
"""

# Acceleration due to gravity (m/s2).  mod_scalars.F:466
g = 9.81

# Mean seawater density (kg/m3) for the Boussinesq approximation.
# mod_scalars.F:787
rho0_default = 1025.0

# Specific heat of seawater (J/kg/degC).  mod_scalars.F:456
Cp = 3985.0

# von Karman constant.
vonKar = 0.41

# Earth radius (m), for spherical grids.
Eradius = 6371315.0

# Power-law barotropic filter shape parameters.  mod_scalars.F:327-329
Falpha = 2.0
Fbeta = 4.0
Fgamma = 0.284

# Day length in seconds.
day2sec = 86400.0
sec2day = 1.0 / 86400.0

import math

pi = math.pi
deg2rad = pi / 180.0
rad2deg = 180.0 / pi

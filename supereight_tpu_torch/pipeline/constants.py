"""Pipeline constants (reference `se_denseslam/include/se/constant_parameters.h:17-37`)."""

E_DELTA = 0.1            # bilateral filter intensity sigma
RADIUS = 2               # bilateral filter window radius
DIST_THRESHOLD = 0.1     # ICP data-association distance gate (m)
NORMAL_THRESHOLD = 0.8   # ICP normal-dot gate
TRACK_THRESHOLD = 0.15   # min inlier ratio before pose revert
MAX_WEIGHT = 100.0       # TSDF weight cap
NEAR_PLANE = 0.4         # raycast near plane (m)
FAR_PLANE = 4.0          # raycast far plane (m)
GAUSSIAN_DELTA = 4.0     # bilateral filter spatial sigma
LIGHT = (1.0, 1.0, -1.0)
AMBIENT = (0.1, 0.1, 0.1)
INVALID = -2.0           # invalid-normal marker (commons.h:71)

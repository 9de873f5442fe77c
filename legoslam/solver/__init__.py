from legoslam.solver import robust, reprojection, schur, lm, pcg  # noqa: F401

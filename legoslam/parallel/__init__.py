from legoslam.parallel import mesh, dist_ba  # noqa: F401

from legoslam.geometry import se3, camera, triangulation  # noqa: F401

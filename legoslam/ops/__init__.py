from legoslam.ops import interp, pyramid, klt, detect  # noqa: F401

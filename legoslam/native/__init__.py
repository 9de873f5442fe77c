from legoslam.native import loader  # noqa: F401

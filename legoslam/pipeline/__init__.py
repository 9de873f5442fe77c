from legoslam.pipeline import state, frontend, backend, dataset, visual_odometry  # noqa: F401

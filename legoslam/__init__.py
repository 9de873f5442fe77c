"""legoslam — a stereo visual SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of LEGO-SLAM
(reference: zha0ming1e/LEGO-SLAM, C++11 + OpenCV + Pangolin):

- pyramid KLT optical-flow tracking, solved with Gauss-Newton per keypoint,
  batched over keypoints (reference: src/algorithm.cpp:37-206),
- motion-only pose estimation and sliding-window bundle adjustment with a
  Levenberg-Marquardt + Schur-complement solver over fixed-shape edge arrays
  (reference: src/lego/base/problem.cpp, src/backend_lego.cpp),
- a masked-array world model replacing the mutex-guarded object graph
  (reference: src/{map,frame,mappoint,feature}.cpp),
- KITTI odometry dataset ingestion and trajectory evaluation/export.

Design stance: the world state is fixed-capacity arrays with validity masks so
every per-frame step jits once and never recompiles; parallelism is batched
keypoints/edges on one device and landmark-sharded Schur reduction across a
`jax.sharding.Mesh` (psum over the interconnect) instead of the reference's
threads.
"""

__version__ = "0.1.0"

from legoslam.geometry import se3, camera, triangulation  # noqa: F401

"""Dump the bench frame sequence to a raw binary for native consumers.

The reference-equivalent CPU baseline (`native/ref_baseline.cpp`) must run on
the *same* imagery as `bench.py` so the fps comparison is apples-to-apples.
This dumps the identical SyntheticPlanesDataset sequence (same shape, speed,
seeds) to a flat file:

  header: int32 n, H, W, pad; float64 fx, fy, cx, cy, baseline
  body:   n x (left u8[H*W], right u8[H*W])

Usage: python scripts/dump_bench_frames.py [/tmp/legoslam_ref_frames.bin]
"""

import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPE = (188, 620)   # bench.py SHAPE (KITTI half resolution, dataset.cpp:76)
N_FRAMES = 160       # bench.py N_FRAMES


def main():
    # The renderer is pure NumPy; keep JAX off the accelerator (this script
    # may run while a bench/profile process owns the GPU).  Flip the config
    # too, in case jax was already imported (backends initialize lazily).
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/legoslam_ref_frames.bin"
    from legoslam.pipeline.dataset import SyntheticPlanesDataset

    H, W = SHAPE
    cache = f"/tmp/legoslam_bench_{H}x{W}_{N_FRAMES}.npz"  # bench.load_frames cache
    ds = SyntheticPlanesDataset(
        n_frames=N_FRAMES, shape=SHAPE, focal=360.0, baseline=0.54, speed=0.12,
        half_width=10.0, length=200.0,
    )
    ds.init()
    cam = ds.rig.left
    if os.path.exists(cache):
        data = np.load(cache)
        frames = list(zip(data["left"], data["right"]))
    else:
        frames = []
        for _ in range(N_FRAMES):
            fr = ds.next_frame()
            frames.append((fr.left, fr.right))
    with open(out, "wb") as f:
        f.write(struct.pack("<4i", len(frames), H, W, 0))
        f.write(struct.pack("<5d", float(cam.fx), float(cam.fy), float(cam.cx),
                            float(cam.cy), float(cam.baseline)))
        for left, right in frames:
            f.write(np.clip(np.asarray(left), 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(np.asarray(right), 0, 255).astype(np.uint8).tobytes())
    print(out)


if __name__ == "__main__":
    main()

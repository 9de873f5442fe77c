"""Device-trace profiler: per-stage GPU time and idle share of the frame step.

Captures a `jax.profiler` trace of the production frame step (bench
deployment: KITTI half resolution, 512 lanes, inline window BA) on the GPU
and reads the trace's xplane with `jax.profiler.ProfileData`:

- device busy time is the union of the kernel and copy intervals on the
  `/device:GPU:N` planes, and the idle share is 1 - busy / span of the
  traced window;
- each device event names the HLO instruction (`hlo_op`) or the kernel that
  ran; the optimized HLO of the compiled step maps either to its
  `jax.named_scope` path, which gives the pipeline stage (pyramid,
  klt_track, pose_solve, gftt_detect, stereo_match, window BA ...);
- device-to-host copies per frame count the host round trips, such as an
  XLA `while` loop reading its predicate every iteration.

Fails loudly when the trace holds no GPU device events: a CPU run has no
device time to report.

Usage:  python scripts/profile_trace.py [--frames N] [--trace-dir DIR]
"""

import argparse
import collections
import glob
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = [
    "pyr_build_l",
    "pyr_build_r",
    "klt_track",
    "pose_solve",
    "gftt_detect",
    "extract_anchors",
    "stereo_match",
    "triangulate",
    "ba_build_problem",
    "lm_linear_solve",
    "lm_retract",
    "lm_chi_build",
    "ba_lm_solve",      # catch-all for BA solve ops not in the 3 sub-scopes
    "ba_outliers",
    "window_ba",        # catch-all for merge etc.
]
SHAPE = (188, 620)
WARMUP = 6


def build_step(n_frames):
    """The bench deployment's jitted frame step and its frames on device."""
    import jax
    import jax.numpy as jnp

    from legoslam.pipeline import backend as backend_mod
    from legoslam.pipeline import frontend as frontend_mod
    from legoslam.pipeline import visual_odometry as vo_mod
    from legoslam.pipeline.dataset import SyntheticPlanesDataset
    from legoslam.utils.config import Config

    ds = SyntheticPlanesDataset(
        n_frames=n_frames, shape=SHAPE, focal=360.0, baseline=0.54, speed=0.12,
        half_width=10.0, length=200.0,
    )
    ds.init()
    frames = [ds.next_frame() for _ in range(n_frames)]
    config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0})
    cfg = frontend_mod.FrontendConfig.from_config(config)
    ba_cfg = backend_mod.BAConfig(assembly_precision=str(config["ba_assembly_precision"]))

    def step(carry, img_l, img_r, frame_id):
        return vo_mod.process_frame(cfg, ds.rig, carry, img_l, img_r, frame_id, ba_cfg=ba_cfg)

    device_frames = [
        (jnp.asarray(f.left, jnp.float32), jnp.asarray(f.right, jnp.float32)) for f in frames
    ]
    return jax.jit(step, donate_argnums=(0,)), vo_mod.initial_carry(cfg, SHAPE), device_frames


def scope_map(hlo_text):
    """HLO instruction or kernel name -> its `op_name` metadata (the
    named-scope path).

    Inside XLA's command buffers a device event names its kernel, not its
    instruction, so each instruction is also keyed by its kernel spelling
    (`loop_add_fusion.3` launches `loop_add_fusion_3`), and each Pallas
    (Triton) custom call by the kernel name in its backend config.
    Library kernels (cuBLAS, cuSOLVER) launched from a command buffer stay
    unattributed.
    """
    out = {}
    for line in hlo_text.splitlines():
        inst = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+) = ", line)
        op = re.search(r'op_name="([^"]*)"', line)
        if not (inst and op):
            continue
        out[inst.group(1)] = op.group(1)
        out.setdefault(re.sub(r"[.\-]", "_", inst.group(1)), op.group(1))
        if "__gpu$xla.gpu.triton" in line:
            for name in re.findall(r'name\W{1,6}(\w+)', line[line.find("backend_config"):]):
                out.setdefault(name, op.group(1))
    return out


def classify(op_name):
    """Innermost named-scope stage in an op's scope path."""
    cands = [(op_name.rfind(s), s) for s in STAGES if s in op_name]
    return max(cands)[1] if cands else "other"


def device_events(trace_dir):
    """[(name, hlo_op, start_ns, end_ns)] from every GPU device plane of the
    newest trace under `trace_dir`; raises if there is none."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                hlo_op = next((str(v) for k, v in e.stats if k == "hlo_op"), "")
                events.append((e.name, hlo_op, e.start_ns, e.end_ns))
    if not events:
        raise RuntimeError(f"no GPU device events in {trace_dir}: nothing ran on a GPU")
    return events


def busy_ns(events):
    """Length of the union of the events' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, _, s, e in sorted(events, key=lambda ev: ev[2]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def report(events, scopes, n, kf_frames):
    span = max(e for *_, e in events) - min(s for _, _, s, _ in events)
    busy = busy_ns(events)
    by_stage = collections.Counter()
    by_kernel = collections.Counter()
    for name, hlo_op, s, e in events:
        op_name = scopes.get(hlo_op) or scopes.get(name)
        by_stage[classify(op_name) if op_name else "unattributed"] += e - s
        by_kernel[name[:70]] += e - s
    d2h = sum(1 for name, *_ in events if name == "MemcpyD2H")
    print(f"\n=== device time by stage ({n} frames, {kf_frames} keyframes) ===")
    print(f"{'stage':<20}{'total ms':>10}{'ms/frame':>10}")
    for st, dur in by_stage.most_common():
        print(f"{st:<20}{dur / 1e6:>10.3f}{dur / 1e6 / n:>10.4f}")
    print(f"trace span {span / 1e6:.3f} ms, device busy {busy / 1e6:.3f} ms, "
          f"idle share {1 - busy / span:.3f}, device-to-host copies per frame {d2h / n:.2f}")
    print("\n=== top kernels ===")
    for name, dur in by_kernel.most_common(20):
        print(f"  {dur / 1e6:>8.3f} ms  {name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--trace-dir", default="out/trace")
    args = ap.parse_args()

    import jax

    from legoslam.utils.jax_setup import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"profile_trace: no GPU (JAX platform {jax.devices()[0].platform!r})")
    enable_compilation_cache()
    step, carry, frames = build_step(WARMUP + args.frames)
    fid = jax.numpy.int32
    step = step.lower(carry, *frames[0], fid(0)).compile()
    scopes = scope_map(step.as_text())
    for i in range(WARMUP):
        carry, _ = step(carry, *frames[i], fid(i))
    jax.block_until_ready(carry)
    kfs = []
    with jax.profiler.trace(args.trace_dir):
        for i in range(WARMUP, len(frames)):
            carry, out = step(carry, *frames[i], fid(i))
            kfs.append(out.kf_inserted)
        jax.block_until_ready(carry)
    print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)
    report(device_events(args.trace_dir), scopes, args.frames, int(np.sum([bool(k) for k in kfs])))


if __name__ == "__main__":
    main()

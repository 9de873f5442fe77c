"""Benchmark: end-to-end SLAM frame throughput on an NVIDIA GPU.

Runs the fused per-frame SLAM step (anchored pyramid KLT + motion-only pose
LM + keyframe detection/stereo/triangulation + inline sliding-window BA) over
a KITTI-half-resolution-sized stereo sequence and reports steady-state
frames/s as ONE JSON line on stdout, naming the device it ran on (platform,
device kind, device count and the nvidia-smi power limit).  It refuses to
run without a GPU: a CPU number is not a device number.

Baseline: the reference (zha0ming1e/LEGO-SLAM) publishes no throughput
numbers (BASELINE.md).  `vs_baseline` divides by an *honest, measured*
denominator: `native/ref_baseline.cpp` re-implements the reference's
frontend workload (cv::calcOpticalFlowPyrLK 11x11x3L tracking, 150-corner
masked GFTT, 4x10 double-precision LM pose rounds, SVD-DLT triangulation —
frontend_lego.cpp:402-447; its backend BA runs on a separate thread and does
not gate frame throughput, backend_lego.cpp:38-54) and is timed on this
host's CPU over the exact same frames.  The measurement is cached in
/tmp/legoslam_ref_cpu.json and refreshed by scripts/bench_reference_cpu.py;
a fallback constant (last measured value) is used if the toolchain is
unavailable.  The old denominator — the viewer's cv::waitKey(120) pacing,
8.33 fps (viewer.cpp:76-79) — is still reported as `vs_viewer_paced`.

Note the workload asymmetry runs in the reference's favor: this pipeline
tracks 512 feature lanes (3.4x the reference's 150) and pays its full
sliding-window BA *inline* on keyframe frames.

Frames come from the procedural plane-world renderer (KITTI imagery is not
present on this machine); set LEGOSLAM_KITTI_DIR to bench on a real KITTI
sequence instead.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_VIEWER_FPS = 8.33      # viewer-paced reference loop (viewer.cpp:76-79)
REFERENCE_CPU_FPS_FALLBACK = 744.0  # measured here 2026-08-20 (ref_baseline.cpp)
REF_CPU_CACHE = "/tmp/legoslam_ref_cpu.json"
SHAPE = (188, 620)    # KITTI half resolution (dataset.cpp:76)
# 160 frames: long enough that the scan program's fixed per-call cost
# amortizes across the window.
N_FRAMES = 160
WARMUP = 4


def reference_cpu_fps():
    """Measured reference-equivalent CPU fps (cached; fallback constant)."""
    try:
        if os.path.exists(REF_CPU_CACHE):
            with open(REF_CPU_CACHE) as f:
                return float(json.load(f)["value"]), "measured (cached)"
        repo = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(
            [sys.executable, os.path.join(repo, "scripts", "bench_reference_cpu.py")],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                rec = json.loads(line)
                with open(REF_CPU_CACHE, "w") as f:
                    json.dump(rec, f)
                return float(rec["value"]), "measured"
    except Exception as e:
        log(f"bench: reference CPU measurement unavailable ({e}); using fallback")
    return REFERENCE_CPU_FPS_FALLBACK, "fallback"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_dataset():
    kitti_dir = os.environ.get("LEGOSLAM_KITTI_DIR")
    if kitti_dir:
        from legoslam.pipeline.dataset import KittiDataset

        ds = KittiDataset(kitti_dir)
        if ds.init():
            log(f"bench: KITTI sequence at {kitti_dir}")
            return ds
        log("bench: KITTI init failed, falling back to synthetic")
    from legoslam.pipeline.dataset import SyntheticPlanesDataset

    return SyntheticPlanesDataset(
        n_frames=N_FRAMES, shape=SHAPE, focal=360.0, baseline=0.54, speed=0.12,
        half_width=10.0, length=200.0,
    )


def load_frames(ds):
    """Pre-render/pre-decode all frames (host I/O is outside the timing)."""
    frames = []
    ds.init()
    for _ in range(N_FRAMES):
        fr = ds.next_frame()
        if fr is None:
            break
        frames.append((fr.left, fr.right))
    return frames


def device_record():
    """The device as JAX reports it, plus the card's nvidia-smi power limit;
    raises when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {devs[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


def main():
    import jax
    import jax.numpy as jnp

    from legoslam.utils.jax_setup import enable_compilation_cache

    device = device_record()
    enable_compilation_cache()

    from legoslam.pipeline import backend as backend_mod
    from legoslam.pipeline import frontend as frontend_mod
    from legoslam.pipeline import visual_odometry as vo_mod
    from legoslam.pipeline.state import Capacities
    from legoslam.utils.config import Config

    ds = make_dataset()
    t0 = time.perf_counter()
    frames = load_frames(ds)
    log(f"bench: {len(frames)} frames prepared in {time.perf_counter() - t0:.1f}s; "
        f"device={jax.devices()[0]}")

    config = Config({
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 60.0,
    })
    cfg = frontend_mod.FrontendConfig.from_config(config)
    ba_cfg = backend_mod.BAConfig(
        assembly_precision=str(config["ba_assembly_precision"]),
    )
    rig = ds.rig

    def step(carry, img_l, img_r, frame_id):
        return vo_mod.process_frame(
            cfg, rig, carry, img_l, img_r, frame_id, ba_cfg=ba_cfg, inline_ba=True
        )

    jitted = jax.jit(step, donate_argnums=(0,))
    carry = vo_mod.initial_carry(cfg, frames[0][0].shape)

    # Upload all frames once (the timed loop measures compute, not PCIe).
    device_frames = [
        (jnp.asarray(l, jnp.float32), jnp.asarray(r, jnp.float32)) for l, r in frames
    ]

    t0 = time.perf_counter()
    for i in range(WARMUP):
        l, r = device_frames[i % len(device_frames)]
        carry, out = jitted(carry, l, r, jnp.asarray(i, jnp.int32))
    jax.block_until_ready(carry)
    log(f"bench: warmup/compile {time.perf_counter() - t0:.1f}s")

    # Timing is repeated REPS times and the best wall-clock kept, so that one
    # host hiccup does not set the result.
    REPS = 3

    def fresh_carry():
        c = vo_mod.initial_carry(cfg, frames[0][0].shape)
        for i in range(WARMUP):
            l, r = device_frames[i]
            c, _ = jitted(c, l, r, jnp.asarray(i, jnp.int32))
        jax.block_until_ready(c)  # drain warmup work before any timed region
        return c

    # --- interactive mode: one program dispatch per frame --------------------
    n = len(device_frames) - WARMUP
    statuses = None
    dt = float("inf")
    for _ in range(REPS):
        c = carry if statuses is None else fresh_carry()
        carry = None  # first rep consumes the warmed carry (it was donated)
        t0 = time.perf_counter()
        outs = []
        for i in range(WARMUP, len(device_frames)):
            l, r = device_frames[i]
            c, out = jitted(c, l, r, jnp.asarray(i, jnp.int32))
            outs.append(out.status)
        jax.block_until_ready(c)
        dt = min(dt, time.perf_counter() - t0)
        statuses = [int(s) for s in outs]
    fps_step = n / dt

    # Strict: only TRACKING_GOOD counts — a run that degrades to TRACKING_BAD
    # must not report ratio 1.0 (ADVICE round 4).
    good = sum(1 for s in statuses if s == 1) / max(1, len(statuses))
    log(f"bench: stepwise {n} frames in {dt:.2f}s -> {fps_step:.2f} fps "
        f"({1e3 * dt / n:.2f} ms/frame), tracking ratio {good:.2f}")

    # --- offline/throughput mode: the whole chunk is ONE XLA program ---------
    # (vo.process_chunk = lax.scan of the identical frame step; equivalence
    # pinned by tests/test_pipeline.py::test_process_chunk_matches_stepwise).
    chunk = jax.jit(
        lambda c, l, r, fid: vo_mod.process_chunk(
            cfg, rig, c, l, r, fid, ba_cfg=ba_cfg, inline_ba=True
        ),
        donate_argnums=(0,),
    )
    il = jnp.stack([f[0] for f in device_frames[WARMUP:]])
    ir = jnp.stack([f[1] for f in device_frames[WARMUP:]])
    fids = jnp.arange(WARMUP, len(device_frames), dtype=jnp.int32)

    c2, outs2 = chunk(fresh_carry(), il, ir, fids)   # compile + run
    jax.block_until_ready(outs2.status)
    dt2 = float("inf")
    for _ in range(REPS):
        c2 = fresh_carry()
        t0 = time.perf_counter()
        c2, outs2 = chunk(c2, il, ir, fids)
        jax.block_until_ready(outs2.status)
        dt2 = min(dt2, time.perf_counter() - t0)
    fps = n / dt2
    tracked = [int(t) for t in outs2.n_tracked]
    mean_tracked = sum(tracked) / max(1, len(tracked))
    log(f"bench: scan-fused {n} frames in {dt2:.2f}s -> {fps:.2f} fps "
        f"({1e3 * dt2 / n:.2f} ms/frame), mean tracked features {mean_tracked:.0f}")

    # --- matched-workload config: like-for-like with the CPU baseline -------
    # The reference baseline (ref_baseline.cpp) tracks 150 corners and runs NO
    # BA on the frame thread (the reference backend solves on a separate
    # thread, backend_lego.cpp:38-54).  The full-fat pipeline above carries up
    # to 512 feature lanes and pays sliding-window BA inline.  This config
    # matches the baseline's workload: 192 feature lanes (GFTT budget 150,
    # like the reference's num_features) and BA excluded; keyframe work
    # (detect / stereo / triangulate) stays, exactly as in ref_baseline.cpp.
    caps_m = Capacities(max_features=192)
    cfg_m = cfg._replace(
        caps=caps_m,
        gftt=cfg.gftt._replace(max_corners=150),
    )

    def step_m(carry, img_l, img_r, frame_id):
        return vo_mod.process_frame(
            cfg_m, rig, carry, img_l, img_r, frame_id, inline_ba=False
        )

    jitted_m = jax.jit(step_m, donate_argnums=(0,))

    def fresh_carry_m():
        c = vo_mod.initial_carry(cfg_m, frames[0][0].shape)
        for i in range(WARMUP):
            l, r = device_frames[i]
            c, _ = jitted_m(c, l, r, jnp.asarray(i, jnp.int32))
        jax.block_until_ready(c)
        return c

    cm = fresh_carry_m()
    dt_m = float("inf")
    statuses_m = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        outs = []
        for i in range(WARMUP, len(device_frames)):
            l, r = device_frames[i]
            cm, out = jitted_m(cm, l, r, jnp.asarray(i, jnp.int32))
            outs.append(out.status)
        jax.block_until_ready(cm)
        dt_m = min(dt_m, time.perf_counter() - t0)
        statuses_m = [int(s) for s in outs]
        cm = fresh_carry_m()
    chunk_m = jax.jit(
        lambda c, l, r, fid: vo_mod.process_chunk(cfg_m, rig, c, l, r, fid, inline_ba=False),
        donate_argnums=(0,),
    )
    cm2, outs_m = chunk_m(fresh_carry_m(), il, ir, fids)
    jax.block_until_ready(outs_m.status)
    dt_m2 = float("inf")
    for _ in range(REPS):
        cm2 = fresh_carry_m()
        t0 = time.perf_counter()
        cm2, outs_m = chunk_m(cm2, il, ir, fids)
        jax.block_until_ready(outs_m.status)
        dt_m2 = min(dt_m2, time.perf_counter() - t0)
    fps_matched = n / min(dt_m, dt_m2)
    good_m = sum(1 for s in statuses_m if s == 1) / max(1, len(statuses_m))
    tracked_m = [int(t) for t in outs_m.n_tracked]
    mean_tracked_m = sum(tracked_m) / max(1, len(tracked_m))
    log(f"bench: matched-workload (192 lanes, no inline BA) {fps_matched:.2f} fps "
        f"({1e3 * min(dt_m, dt_m2) / n:.2f} ms/frame, stepwise {n/dt_m:.1f} / "
        f"scan {n/dt_m2:.1f}), tracking ratio {good_m:.2f}, "
        f"mean tracked {mean_tracked_m:.0f}")

    # --- async BA: the reference's backend-thread split, measured -----------
    # ba_mode=async removes the window solve from the keyframe frame's
    # critical path (pipeline/async_backend.py).  Throughput uses free-running
    # dispatch; the per-frame latency split (tracking vs keyframe frames,
    # inline vs async) blocks on each frame's pose output.
    from legoslam.pipeline.visual_odometry import VisualOdometry

    class _ListDataset:
        def __init__(self, frames, rig):
            self.frames, self.rig, self.i = frames, rig, 0

        def init(self):
            self.i = 0
            return True

        def next_frame(self):
            from legoslam.pipeline.dataset import StereoFrame

            if self.i >= len(self.frames):
                return None
            l, r = self.frames[self.i]
            fr = StereoFrame(self.i, l, r)
            self.i += 1
            return fr

    vo_config = Config({
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 60.0,
    })

    def vo_run(mode, latency=False):
        vo = VisualOdometry(
            config=vo_config, dataset=_ListDataset(frames, rig), ba_mode=mode
        )
        assert vo.init()
        for _ in range(WARMUP):  # warmup/compile outside timing
            vo.step()
        jax.block_until_ready(vo.carry)
        lat_kf, lat_tr = [], []
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            # _next_frame keeps the driver's upload lookahead engaged (the
            # transfer of frame k+1 overlaps frame k's step).
            fr = vo._next_frame()
            if fr is None:
                break
            out = vo.process(fr)
            if latency:
                jax.block_until_ready(out.T_cw)
                (lat_kf if bool(out.kf_inserted) else lat_tr).append(
                    (time.perf_counter() - t1) * 1e3
                )
        vo.flush_ba()
        jax.block_until_ready(vo.carry)
        dt = time.perf_counter() - t0
        return n / dt, lat_tr, lat_kf

    def pct(v, p):
        return float(np.percentile(v, p)) if v else float("nan")

    fps_async, _, _ = vo_run("async")
    fps_inline_vo, _, _ = vo_run("inline")
    _, ltr_a, lkf_a = vo_run("async", latency=True)
    _, ltr_i, lkf_i = vo_run("inline", latency=True)
    log(f"bench: VO-driver inline {fps_inline_vo:.1f} fps / async {fps_async:.1f} fps")
    log("bench: per-frame latency ms (median/p90): "
        f"inline tracking {pct(ltr_i,50):.2f}/{pct(ltr_i,90):.2f} "
        f"keyframe {pct(lkf_i,50):.2f}/{pct(lkf_i,90):.2f} | "
        f"async tracking {pct(ltr_a,50):.2f}/{pct(ltr_a,90):.2f} "
        f"keyframe {pct(lkf_a,50):.2f}/{pct(lkf_a,90):.2f}")

    ref_fps, ref_src = reference_cpu_fps()
    log(f"bench: reference-equivalent CPU frontend {ref_fps:.1f} fps ({ref_src}, "
        f"150 feature tracks, no BA)")
    # Headline = the faster of the two equivalent execution modes: stepwise
    # (deep async per-frame dispatch — wins when the host keeps the queue
    # full) vs scan-fused (one program — wins when the host is contended).
    mode = "scan" if fps >= fps_step else "stepwise"
    best = max(fps, fps_step)
    print(json.dumps({
        "metric": "slam_frames_per_second",
        "device": device,
        "value": round(best, 3),
        "unit": "frames/s",
        # Like-for-like comparison: matched workload (192 lanes / 150-corner
        # GFTT budget, BA excluded) vs the measured reference-equivalent CPU
        # frontend (150 tracks, BA on a separate thread).
        "vs_baseline": round(fps_matched / ref_fps, 3),
        "fps_matched": round(fps_matched, 3),
        "matched_tracking_ratio": round(good_m, 3),
        # Full-fat production config (512 lanes + inline sliding-window BA)
        # against the same BA-less 150-track denominator.
        "vs_baseline_fullfat": round(best / ref_fps, 3),
        "mode": mode,
        "fps_scan": round(fps, 3),
        "fps_stepwise": round(fps_step, 3),
        # the reference's backend-thread split (ba_mode=async), run through
        # the full VisualOdometry driver incl. host hooks
        "fps_async": round(fps_async, 3),
        "kf_latency_ms_inline": round(pct(lkf_i, 50), 2),
        "kf_latency_ms_async": round(pct(lkf_a, 50), 2),
        "reference_cpu_fps": round(ref_fps, 1),
        "reference_cpu_source": ref_src,
        "mean_tracked_features": round(mean_tracked, 1),
        "vs_viewer_paced": round(best / REFERENCE_VIEWER_FPS, 3),
    }))


if __name__ == "__main__":
    main()

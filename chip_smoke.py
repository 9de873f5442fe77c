#!/usr/bin/env python
"""Smoke test of the stereo SLAM main path on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: phases (a)-(d)
    python chip_smoke.py --gpus 4   # four GPUs of one host: phases (a), (e)

(a) device: JAX's first device must be a GPU; prints the card's name and
    power limit from nvidia-smi.
(b) main path: `VisualOdometry` on the bench deployment (KITTI half
    resolution 188x620, default capacities, anchored 3-level KLT, motion-only
    pose LM, GFTT/scanline stereo/triangulation keyframes, inline window BA)
    for FRAMES frames, against the same run on the CPU at f32 in a child
    process that never touches the GPU (JAX_PLATFORMS=cpu).
(c) `process_chunk` (one scan program) against the stepwise run of (b).
(d) each Pallas kernel of the path, compiled for the GPU, against its plain
    XLA version at real widths (512 lanes on the 188x620, 94x310 and 47x155
    levels; E=512 pose edges), both at HIGHEST precision, with the median of
    REPS timed calls on fresh inputs.
(e) with --gpus 4: window BA sharded over a 4-GPU mesh against the
    single-GPU solve at K=16, L=2048, E=5120; and `ba_mode: async` with BA on
    GPU 1 against inline BA.

Exits non-zero when any phase fails or no GPU is found.  The last line of
stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FRAMES = 64
SHAPE = (188, 620)
REPS = 25
# Scene and deployment settings shared with bench.py: the procedural corridor
# at KITTI half resolution, with depth gates sized to it.
DATASET_KW = dict(n_frames=FRAMES, shape=SHAPE, focal=360.0, baseline=0.54,
                  speed=0.12, half_width=10.0, length=200.0)
CONFIG = {"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0}
# Bounds on two runs of the main path that should agree: GPU against CPU in
# phase (b), async against inline BA in phase (e).  GPU results are not
# bit-reproducible and the closed tracking loop amplifies last-bit
# differences, so positions are held to 10 cm at every frame, not to
# rounding (see PERF.md for the measured spread).
MIN_STATUS_AGREEMENT = 0.95
MAX_KF_COUNT_DIFF = 1
MAX_POSITION_DIFF_M = 0.10
MAX_ATE_M = 0.15
# Phase (c): the bound of tests/test_pipeline.py::test_process_chunk_matches_stepwise.
MAX_CHUNK_POSITION_DIFF_M = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


class Check:
    """Collects named pass/fail results of one phase."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []

    def __call__(self, name: str, ok: bool, detail: str) -> None:
        log(f"[{self.phase}] {'ok  ' if ok else 'FAIL'} {name}: {detail}")
        if not ok:
            self.failed.append(name)


# --------------------------------------------------------------------------
# (b) main path
# --------------------------------------------------------------------------

def run_vo(ba_mode: str = "inline", extra=None):
    """Drive VisualOdometry the way apps/run_synthetic.py does."""
    from legoslam.pipeline.dataset import SyntheticPlanesDataset
    from legoslam.pipeline.visual_odometry import VisualOdometry
    from legoslam.utils import evaluation
    from legoslam.utils.config import Config

    ds = SyntheticPlanesDataset(**DATASET_KW)
    vo = VisualOdometry(config=Config({**CONFIG, **(extra or {})}), dataset=ds, ba_mode=ba_mode)
    if not vo.init():
        raise RuntimeError("VisualOdometry.init failed")
    t0 = time.perf_counter()
    vo.run()
    T_wc = vo.trajectory_T_wc()
    seconds = time.perf_counter() - t0
    ab = vo.async_backend
    return {
        "ba_device": str(ab.ba_device) if ab is not None else None,
        "async_stats": dict(ab.stats) if ab is not None else None,
        "positions": T_wc[:, :3, 3].tolist(),
        "statuses": vo.statuses().tolist(),
        "kf": [bool(o.kf_inserted) for o in vo.outputs],
        "ate": float(evaluation.ate_rmse(T_wc[:, :3, 3], ds.ground_truth[: len(T_wc), :3, 3])),
        "seconds": seconds,
    }


def compare_runs(check: Check, a: dict, b: dict, name_a: str, name_b: str) -> None:
    sa, sb = np.asarray(a["statuses"]), np.asarray(b["statuses"])
    agree = float((sa == sb).mean())
    check("status agreement", agree >= MIN_STATUS_AGREEMENT,
          f"{agree:.4f} of {len(sa)} frames (bound >= {MIN_STATUS_AGREEMENT})")
    ka, kb = int(np.sum(a["kf"])), int(np.sum(b["kf"]))
    check("keyframe count", abs(ka - kb) <= MAX_KF_COUNT_DIFF,
          f"{name_a} {ka}, {name_b} {kb} (bound +-{MAX_KF_COUNT_DIFF})")
    d = np.linalg.norm(np.asarray(a["positions"]) - np.asarray(b["positions"]), axis=-1)
    check("position difference", float(d.max()) <= MAX_POSITION_DIFF_M,
          f"max {d.max():.5f} m at frame {int(d.argmax())}, median {np.median(d):.5f} m "
          f"(bound {MAX_POSITION_DIFF_M} m)")
    for name, r in ((name_a, a), (name_b, b)):
        check(f"ATE {name}", r["ate"] < MAX_ATE_M, f"{r['ate']:.5f} m (bound {MAX_ATE_M} m)")


def start_cpu_reference() -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )


def finish_cpu_reference(proc: subprocess.Popen, timeout: float) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CPU reference failed ({proc.returncode}):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# (c) process_chunk
# --------------------------------------------------------------------------

def run_chunk():
    import jax
    import jax.numpy as jnp

    from legoslam.pipeline import backend as backend_mod
    from legoslam.pipeline import frontend as frontend_mod
    from legoslam.pipeline import visual_odometry as vo_mod
    from legoslam.pipeline.dataset import SyntheticPlanesDataset
    from legoslam.utils.config import Config

    ds = SyntheticPlanesDataset(**DATASET_KW)
    ds.init()
    frames = [ds.next_frame() for _ in range(FRAMES)]
    config = Config(CONFIG)
    cfg = frontend_mod.FrontendConfig.from_config(config)
    ba_cfg = backend_mod.BAConfig(assembly_precision=str(config["ba_assembly_precision"]))
    chunk = jax.jit(lambda c, l, r, f: vo_mod.process_chunk(
        cfg, ds.rig, c, l, r, f, ba_cfg=ba_cfg, inline_ba=True))
    il = jnp.asarray(np.stack([f.left for f in frames]), jnp.float32)
    ir = jnp.asarray(np.stack([f.right for f in frames]), jnp.float32)
    fids = jnp.asarray([f.frame_id for f in frames], jnp.int32)
    _, outs = chunk(vo_mod.initial_carry(cfg, SHAPE), il, ir, fids)
    T_wc = np.linalg.inv(np.asarray(outs.T_cw))
    return {
        "positions": T_wc[:, :3, 3].tolist(),
        "statuses": np.asarray(outs.status).tolist(),
        "kf": np.asarray(outs.kf_inserted).tolist(),
    }


# --------------------------------------------------------------------------
# (d) kernels against XLA
# --------------------------------------------------------------------------

def _timed_median_ms(fn, inputs):
    import jax

    jax.block_until_ready(fn(*inputs[0]))          # compile + warm-up
    times = []
    for args in inputs[1:]:
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), len(times)


def klt_inputs(n_sets: int):
    """Anchored tracking problems from consecutive bench frames: 512 lanes
    of GFTT corners with templates on frame i, tracked into frame i + 1."""
    import jax
    import jax.numpy as jnp

    from legoslam.ops import detect, klt, pyramid
    from legoslam.pipeline.dataset import SyntheticPlanesDataset

    ds = SyntheticPlanesDataset(**{**DATASET_KW, "n_frames": n_sets + 1})
    ds.init()
    imgs = [jnp.asarray(ds.next_frame().left, jnp.float32) for _ in range(n_sets + 1)]
    cfg = klt.KLTConfig(levels=3)
    gftt = detect.GFTTConfig(max_corners=512, min_distance=6)

    @jax.jit
    def prepare(img1, img2):
        pyr1 = tuple(pyramid.build_pyramid(img1, cfg.levels))
        pyr2 = tuple(pyramid.build_pyramid(img2, cfg.levels))
        kp, valid = detect.detect(img1, gftt)
        return klt.extract_anchors(pyr1, kp, cfg), kp, pyr2, kp, valid

    return cfg, [prepare(imgs[i], imgs[i + 1]) for i in range(n_sets)]


def pose_inputs(n_sets: int, E: int = 512):
    """Motion-only pose problems with E edges, 10% gross outliers."""
    import jax.numpy as jnp

    from legoslam.geometry import se3

    out = []
    for seed in range(n_sets):
        rng = np.random.default_rng(seed)
        z = rng.uniform(4.0, 60.0, E)
        P = np.stack([rng.uniform(-0.8, 0.8, E) * z, rng.uniform(-0.3, 0.3, E) * z, z], -1)
        xi = np.asarray([0.1, -0.05, 0.3, 0.01, 0.02, -0.01]) * rng.uniform(0.5, 1.5)
        T_true = np.asarray(se3.se3_exp(jnp.asarray(xi, jnp.float32)))
        pc = P @ T_true[:3, :3].T + T_true[:3, 3]
        uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
        uv += rng.normal(0, 0.3, uv.shape)
        uv[: E // 10] += rng.normal(0, 30.0, (E // 10, 2))
        out.append((
            jnp.asarray(np.eye(4), jnp.float32), jnp.asarray(P, jnp.float32),
            jnp.asarray(uv, jnp.float32), jnp.asarray(rng.uniform(size=E) > 0.05),
        ))
    return out


def phase_kernels(check: Check, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from legoslam.ops import klt, klt_pallas
    from legoslam.solver import lm, pose_pallas, reprojection
    from legoslam.utils.jax_setup import full_f32_matmuls

    cfg, sets = klt_inputs(REPS + 1)
    kern = jax.jit(full_f32_matmuls(lambda a, u, p, g, v: klt_pallas.klt_pyramid_anchored_pallas(
        a, u, p, g, v, iterations=cfg.iterations, eps=cfg.eps, scale=cfg.scale)))
    xla = jax.jit(full_f32_matmuls(lambda a, u, p, g, v: klt._pyramid_anchored_xla(
        a, u, p, g, v, cfg)))
    kp_k, ok_k = kern(*sets[0])
    kp_x, ok_x = xla(*sets[0])
    ok_k, ok_x = np.asarray(ok_k), np.asarray(ok_x)
    agree = float((ok_k == ok_x).mean())
    both = ok_k & ok_x
    diff = np.abs(np.asarray(kp_k) - np.asarray(kp_x)).max(-1)[both]
    valid = np.asarray(sets[0][4])
    check("klt success agreement", agree >= 0.98 and both.sum() >= 0.5 * valid.sum(),
          f"{agree:.4f} over {len(ok_k)} lanes, {int(both.sum())} tracked by both "
          f"of {int(valid.sum())} valid")
    check("klt position agreement", float(np.percentile(diff, 99)) < 0.05,
          f"max {diff.max():.2e} px, p99 {np.percentile(diff, 99):.2e} px (bound p99 < 0.05)")
    t_k, n = _timed_median_ms(kern, sets)
    t_x, _ = _timed_median_ms(xla, sets)
    log(f"[d] klt_pyramid_anchored (512 lanes, levels 188x620/94x310/47x155) on {card}: "
        f"Pallas {t_k:.4f} ms, XLA {t_x:.4f} ms (median of {n} runs)")

    intr = reprojection.Intrinsics(fx=360.0, fy=360.0, cx=310.0, cy=94.0)
    intr_vec = jnp.asarray([360.0, 360.0, 310.0, 94.0], jnp.float32)
    psets = pose_inputs(REPS + 1)
    pk = jax.jit(full_f32_matmuls(lambda T, P, uv, v: pose_pallas.estimate_pose_pallas(
        intr_vec, T, P, uv, v)))
    px = jax.jit(full_f32_matmuls(lambda T, P, uv, v: lm.estimate_pose(intr, T, P, uv, v)))
    Tk, ik, nk = pk(*psets[0])
    Tx, ix, nx = px(*psets[0])
    dT = float(np.abs(np.asarray(Tk) - np.asarray(Tx)).max())
    ia = float((np.asarray(ik) == np.asarray(ix)).mean())
    check("pose agreement", dT < 1e-3 and ia >= 0.98,
          f"max |dT| {dT:.2e}, inlier agreement {ia:.4f}, inliers {int(nk)} vs {int(nx)}")
    t_k, n = _timed_median_ms(pk, psets)
    t_x, _ = _timed_median_ms(px, psets)
    log(f"[d] estimate_pose (E=512) on {card}: Pallas {t_k:.4f} ms, XLA {t_x:.4f} ms "
        f"(median of {n} runs)")


# --------------------------------------------------------------------------
# (e) four GPUs
# --------------------------------------------------------------------------

def phase_four_gpus(check: Check) -> None:
    import jax

    from legoslam.parallel import dist_ba, mesh as mesh_mod
    from legoslam.solver import lm
    from legoslam.utils.jax_setup import full_f32_matmuls

    graph, poses0, pts0 = dist_ba.synthetic_window(np.random.default_rng(7))
    cfg = lm.LMConfig(iterations=8)
    single = jax.jit(full_f32_matmuls(lambda g, p, x: lm.solve_ba(g, p, x, cfg=cfg)))
    solve_fn = dist_ba.make_dist_solve_fn(mesh_mod.make_mesh(jax.devices()[:4]))
    dist = jax.jit(full_f32_matmuls(lambda g, p, x: solve_fn(g, p, x, cfg)))
    st_s, res_s = single(graph, poses0, pts0)
    st_d, res_d = dist(graph, poses0, pts0)
    chi_s, chi_d = float(res_s.chi), float(res_d.chi)
    rel = abs(chi_d - chi_s) / max(chi_s, 1e-9)
    check("dist BA chi", rel < 1e-2, f"4-GPU {chi_d:.4f} vs 1-GPU {chi_s:.4f}, rel {rel:.2e} (bound 1e-2)")
    dp = float(np.abs(np.asarray(st_d.poses) - np.asarray(st_s.poses)).max())
    check("dist BA poses", dp < 1e-3, f"max |dT| {dp:.2e} (bound 1e-3)")
    for name, fn in (("1-GPU", single), ("4-GPU", dist)):
        ms, n = _timed_median_ms(fn, [(graph, poses0, pts0)] * 6)
        log(f"[e] window BA solve {name}: {ms:.3f} ms (median of {n})")

    inline = run_vo("inline")
    async_ = run_vo("async", extra={"ba_async_device": "auto"})
    log(f"[e] inline {inline['seconds']:.2f} s, async {async_['seconds']:.2f} s for {FRAMES} "
        f"frames (compile included)")
    check("async BA device", async_["ba_device"] == str(jax.devices()[1])
          and async_["async_stats"]["merged"] > 0,
          f"BA on {async_['ba_device']}, {async_['async_stats']}")
    compare_runs(check, async_, inline, "async", "inline")


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1)
    ap.add_argument("--cpu-reference", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import jax

    if args.cpu_reference:
        from legoslam.utils.jax_setup import enable_compilation_cache

        enable_compilation_cache()
        print(json.dumps(run_vo("inline")))
        return 0

    # (a) device
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})", file=sys.stderr)
        return 2
    if len(devices) < args.gpus:
        print(f"chip_smoke: {args.gpus} GPUs asked, {len(devices)} found", file=sys.stderr)
        return 2
    card = card_info()
    log(f"[a] {len(devices)} x {devices[0].device_kind}; nvidia-smi:")
    log(card)

    from legoslam.utils.jax_setup import enable_compilation_cache

    log(f"[a] compile cache: {enable_compilation_cache()}")
    failed = []
    t_start = time.perf_counter()
    if args.gpus == 4:
        check = Check("e")
        phase_four_gpus(check)
        failed += check.failed
    else:
        ref = start_cpu_reference()
        try:
            check = Check("b")
            gpu = run_vo("inline")
            log(f"[b] GPU run: {FRAMES} frames in {gpu['seconds']:.2f} s (compile included)")
            check_c = Check("c")
            chunk = run_chunk()
            check_c("statuses equal", chunk["statuses"] == gpu["statuses"], "scan vs stepwise")
            check_c("keyframes equal", chunk["kf"] == gpu["kf"], "scan vs stepwise")
            d = np.linalg.norm(np.asarray(chunk["positions"]) - np.asarray(gpu["positions"]), axis=-1)
            check_c("position difference", float(d.max()) < MAX_CHUNK_POSITION_DIFF_M,
                    f"max {d.max():.5f} m (bound {MAX_CHUNK_POSITION_DIFF_M} m)")
            check_d = Check("d")
            phase_kernels(check_d, card)
            cpu = finish_cpu_reference(ref, timeout=900)
            log(f"[b] CPU reference: {FRAMES} frames in {cpu['seconds']:.2f} s")
            compare_runs(check, gpu, cpu, "GPU", "CPU")
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
        failed += check.failed + check_c.failed + check_d.failed
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after device check; card: {card}")
    if failed:
        log(f"chip_smoke: FAILED {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

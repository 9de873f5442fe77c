#!/usr/bin/env python
"""Run stereo SLAM on a KITTI odometry sequence.

The analogue of the reference's `legoslam_kitti_feature` app
(app/legoslam_kitti_feature.cpp): one config file (or flags), runs the full
pipeline, exports the trajectory, prints ATE when ground truth is available,
and writes viewer artifacts.

Usage:
  python apps/run_kitti.py --dataset_dir /data/kitti/odometry/sequences/00
  python apps/run_kitti.py --config_file config/kitti_00.yaml
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", default=None, help="YAML config (reference format works)")
    ap.add_argument("--dataset_dir", default=None, help="KITTI sequence directory")
    ap.add_argument("--max_frames", type=int, default=0, help="0 = whole sequence")
    ap.add_argument("--out_dir", default="out", help="trajectory/visualization output")
    ap.add_argument("--no_ba", action="store_true", help="disable sliding-window BA")
    ap.add_argument("--log_every", type=int, default=0,
                    help="log per-frame counters every N frames (0 = silent)")
    ap.add_argument("--verbose", action="store_true",
                    help="per-frame counters + per-iteration BA chi/lambda trace "
                         "(the reference's problem.cpp:180-184 solver log)")
    ap.add_argument("--viz_every", type=int, default=0,
                    help="live viewer stream: keep a feature-overlay + "
                         "follow-mode map frame every N frames and assemble "
                         "a tracking.gif (0 = final-state rendering only)")
    args = ap.parse_args()

    from legoslam.pipeline.dataset import KittiDataset
    from legoslam.pipeline.visual_odometry import VisualOdometry
    from legoslam.utils import evaluation
    from legoslam.utils.config import Config
    from legoslam.utils.logging import get_logger

    log = get_logger("legoslam.app")

    config = Config.from_yaml(args.config_file) if args.config_file else Config()
    if args.dataset_dir:
        config["dataset_dir"] = args.dataset_dir
    if args.verbose:
        config["log_every_n_frames"] = 1
        config["ba_trace"] = True
    elif args.log_every:
        config["log_every_n_frames"] = args.log_every
    if args.viz_every:
        config["viewer_every_n"] = args.viz_every

    dataset = KittiDataset(config["dataset_dir"], scale=config["image_scale"])
    vo = VisualOdometry(config=config, dataset=dataset, inline_ba=not args.no_ba)
    if not vo.init():
        log.error("init failed (check dataset_dir: %s)", config["dataset_dir"])
        return 1

    n = 0
    while vo.step():
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    import jax

    jax.block_until_ready(vo.carry)
    log.info("processed %d frames, %d active keyframes", n, vo.num_keyframes())

    os.makedirs(args.out_dir, exist_ok=True)
    traj_path = os.path.join(args.out_dir, "trajectory_kitti.txt")
    vo.save_trajectory(traj_path, fmt="kitti")
    log.info("trajectory written to %s", traj_path)

    gt = dataset.ground_truth
    if gt is not None:
        est = vo.trajectory_T_wc()
        m = min(len(est), len(gt))
        ate = evaluation.ate_rmse(est[:m, :3, 3], gt[:m, :3, 3])
        rpe_t, rpe_r = evaluation.rpe_rmse(est[:m], gt[:m])
        log.info("ATE RMSE: %.4f m | RPE: %.4f m / %.4f deg per frame", ate, rpe_t, rpe_r)

    paths = vo.save_visualization(args.out_dir, ground_truth=gt)
    for p in paths:
        log.info("wrote %s", p)
    return 0


if __name__ == "__main__":
    sys.exit(main())

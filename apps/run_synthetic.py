#!/usr/bin/env python
"""Run stereo SLAM on the procedural plane-world sequence (no dataset needed).

Companion to apps/run_kitti.py for machines without KITTI; exercises the full
pipeline and reports ATE against the exact synthetic ground truth.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--speed", type=float, default=0.2)
    ap.add_argument("--out_dir", default="out_synth")
    ap.add_argument("--no_ba", action="store_true")
    ap.add_argument("--stop_after", type=int, default=0,
                    help="process only this many frames, then save --save_checkpoint and exit")
    ap.add_argument("--save_checkpoint", default="",
                    help="path to write a VO checkpoint (.npz) at the end of the run")
    ap.add_argument("--load_checkpoint", default="",
                    help="resume from a VO checkpoint written by --save_checkpoint")
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

    from legoslam.pipeline.dataset import SyntheticPlanesDataset
    from legoslam.pipeline.visual_odometry import VisualOdometry
    from legoslam.utils import evaluation
    from legoslam.utils.config import Config
    from legoslam.utils.logging import get_logger

    log = get_logger("legoslam.app")
    ds = SyntheticPlanesDataset(n_frames=args.frames, shape=(160, 240), focal=260.0,
                                baseline=0.54, speed=args.speed)
    config = Config({
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 50.0,
        "detect_mask_half": 6,
        "gftt_min_distance": 6,
    })
    if args.verbose:
        config["log_every_n_frames"] = 1
        config["ba_trace"] = True
    elif args.log_every:
        config["log_every_n_frames"] = args.log_every
    if args.viz_every:
        config["viewer_every_n"] = args.viz_every
    vo = VisualOdometry(config=config, dataset=ds, inline_ba=not args.no_ba)
    assert vo.init()
    if args.load_checkpoint:
        vo.load_checkpoint(args.load_checkpoint)
        log.info("resumed from %s at frame index %d", args.load_checkpoint,
                 ds.current_index)
    if args.stop_after:
        for _ in range(args.stop_after):
            if not vo.step():
                break
    else:
        vo.run()
    if args.save_checkpoint:
        vo.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint written to %s", args.save_checkpoint)

    est = vo.trajectory_T_wc()
    gt = ds.ground_truth[: len(est)]
    ate = evaluation.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    log.info("ATE RMSE: %.4f m over %d frames", ate, len(est))
    os.makedirs(args.out_dir, exist_ok=True)
    vo.save_trajectory(os.path.join(args.out_dir, "trajectory_kitti.txt"))
    for p in vo.save_visualization(args.out_dir, ground_truth=gt):
        log.info("wrote %s", p)
    return 0


if __name__ == "__main__":
    sys.exit(main())

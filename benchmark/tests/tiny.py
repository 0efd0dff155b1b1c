"""A cell's configuration shrunk for a CPU run in the tests: 96x128
frames, a small map and few iterations, the window's stages unchanged."""


def shrink(cfg, spec):
    cfg["cam"].update(H=96, W=128, fx=80.0, fy=80.0, cx=63.5, cy=47.5,
                      H_out=96, W_out=128)
    m = cfg["mapping"]
    m.update(capacity=4096, raster_K=32, pcd_downsample=8,
             pcd_downsample_init=4)
    m["Training"].update(init_itr_num=20, init_gaussian_update=10,
                         init_gaussian_reset=1000, mapping_itr_num=4,
                         window_size=4)
    tr = cfg["tracking"]
    tr.update(buffer=48)
    tr["frontend"].update(window=8)
    if tr.get("oracle"):
        tr["motion_filter"]["thresh"] = 0.4
        tr["frontend"]["keyframe_thresh"] = 0.25
    else:
        # the repository's smoke calibration of the shipped checkpoint
        tr.update(warmup=5)
        tr["motion_filter"]["thresh"] = 1.6
        tr["frontend"].update(keyframe_thresh=0.6, max_factors=24)
        tr["backend"].update(loop_window=8)
        # at 96x128 the checkpoint's disparities neither agree across
        # views within 1 % of the depth nor fit the prior within 10 %:
        # every frame would be bad-mono and stage 2 of DSPO never run
        tr["multiview_filter"]["thresh"] = 1.0
        tr["mono_thres"] = 10.0
    spec["workload"]["n_frames"] = 150
    # at 96x128 only the fast orbit moves enough pixels to admit keyframes
    spec["traffic"]["motion_scale"] = 5.0

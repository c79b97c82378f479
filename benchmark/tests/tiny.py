"""A cell's files at a size a CPU test can hold: a room of a few small
images, 256 rays, a 2^14-row table, short loops."""

from __future__ import annotations

import copy

from benchmark.harness import manifest as mf


def tiny_cell(cell: str):
    """(manifest, configuration file, traffic mix) of ``cell``, shrunk."""
    man = mf.load_manifest()
    w = mf.workload(man, cell)
    conf = copy.deepcopy(mf.config_file(man, w["config"]))
    if conf["room"]["writer"] == "ethz_commonroom":
        conf["room"]["args"].update(n_images=10, img_wh=[64, 48], n_gt_points=20000)
    else:
        conf["room"]["args"].update(n_times=6, img_wh=[64, 48])
    c = conf["config"]
    c["training"]["batch_size"] = 256
    c["model"]["hash_log2_T"] = 14
    c["evaluation"]["batch_size"] = 1024
    c["evaluation"]["res_angular"] = 64
    tr = copy.deepcopy(mf.traffic_file(w["traffic"]))
    tr.update(chunk_steps=24, warmup_steps=48, trace_chunks=1, train_steps=16,
              images=4, warmup_calls=1, trace_calls=2)
    return man, conf, tr

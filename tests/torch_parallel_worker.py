"""One rank of the port's ``parallel/`` test groups (gloo on the CPU).

Run as ``python tests/torch_parallel_worker.py <suite> <rank> <world>
<store> <workdir>``: joins a ``world``-rank gloo group through the
``file://`` store ``<store>``, reads ``<workdir>/inputs.npz``, runs the
suite's port calls at this world size, and writes its results to
``<workdir>/w<world>_r<rank>.npz`` (a call that raises leaves its message
under ``error.<case>``). Imports nothing of JAX; the tests hold the
results against the JAX package in their own process.

Suites: ``parallel`` (halo_map, KMeans, forest DP and TP,
``classify_batch_multihost``'s block check, stacks, the batch programs,
spatial) and ``workflow`` (``run_batch_workflow`` with a mesh).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rs_image_segmentation_tpu_torch.core.config import (  # noqa: E402
    FeatureStageConfig, GLCMConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest  # noqa
from rs_image_segmentation_tpu_torch.ops.stencil import box_filter  # noqa
from rs_image_segmentation_tpu_torch.parallel import (  # noqa: E402
    forest_tp, multihost, sharded, spatial)
from rs_image_segmentation_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh)

STACK_CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=16, step_size=16,
                                               levels=8))
BATCH_CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                               levels=8))


def _fields(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp.files
            if k.startswith(prefix)}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def parallel_suite(inp, world: int) -> dict:
    out = {}
    tile = make_mesh(axis_names=("tile",), device="cpu")
    data = make_mesh(axis_names=("data",), device="cpu")
    model = make_mesh(axis_names=("model",), device="cpu")

    def case(name, fn):
        try:
            res = fn()
        except (ValueError, RuntimeError) as e:
            out[f"error.{name}"] = np.array(str(e))
            return
        for k, v in (res.items() if isinstance(res, dict)
                     else ((None, res),)):
            out[name if k is None else f"{name}.{k}"] = _np(v)

    # halo_map: sufficient halos (3 for a 7 x 7 box, 1 for 3 x 3) and one
    # too small (1 for 7 x 7)
    case("halo7", lambda: sharded.halo_map(
        lambda p: box_filter(p, 7), inp["halo_x"], 3, tile))
    case("halo3", lambda: sharded.halo_map(
        lambda p: box_filter(p, 3), inp["halo_x1"], 1, tile))
    case("halo_small", lambda: sharded.halo_map(
        lambda p: box_filter(p, 7), inp["halo_x"], 1, tile))

    # KMeans: cold (k-means++) and warm-started from JAX's centroids
    def kmeans(init):
        labels, cents = sharded.sharded_kmeans_fit_predict(
            inp["km_x"], 4, data, seed=3, init_centroids=init)
        return {"labels": labels, "cents": cents}
    case("km_cold", lambda: kmeans(None))
    case("km_warm", lambda: kmeans(inp["km_init"]))

    # forest: rows over data (traversal form), leaves over model (TP)
    flat = tforest.flat_forest_from_numpy(_fields(inp, "ff_"))
    case("forest_dp", lambda: sharded.sharded_forest_predict(
        flat, inp["fq_x"], int(inp["ff_depth"]), data, chunk=128))
    gf = tforest.gemm_forest_from_numpy(_fields(inp, "gf_"))
    case("tp", lambda: {
        "predict": forest_tp.tp_forest_predict(gf, inp["tp_x"], model),
        "proba": forest_tp.tp_forest_proba(gf, inp["tp_x"], model)})

    def leaf_shard():
        local = forest_tp.shard_gemm_forest(gf, model)
        return {"leaves": np.array(local.path.shape[1]),
                "predict": forest_tp.tp_forest_predict(
                    local, inp["tp_x"][:1024], model)}
    case("tp_shard", leaf_shard)
    if world == 4:
        grid = make_mesh((2, 2), ("data", "model"), device="cpu")
        case("tp_2x2", lambda: forest_tp.tp_forest_predict(
            gf, inp["tp_x"], grid, data_axis="data"))

    # classify_batch_multihost with a different local batch on every rank
    rank = torch.distributed.get_rank()
    case("multihost_blocks", lambda: multihost.classify_batch_multihost(
        inp["mb_scenes"][:rank + 1], inp["mb_luts"][:rank + 1], gf,
        BATCH_CFG, data))

    # data parallelism over scenes
    case("stack", lambda: sharded.sharded_hierarchical_stack(
        inp["stack_scenes"], data, STACK_CFG))
    case("rule", lambda: sharded.sharded_method_batch(
        inp["mb_scenes"], inp["mb_luts"], data, "rule_based", BATCH_CFG))
    case("kmeans_batch", lambda: sharded.sharded_method_batch(
        inp["mb_scenes"], inp["mb_luts"], data, "kmeans", BATCH_CFG,
        n_clusters=3, fit_stride=2))

    # spatial: rows over tile
    sgf = tforest.gemm_forest_from_numpy(_fields(inp, "sg_"))
    case("scene", lambda: spatial.sharded_classify_scene(
        inp["sp_pre"], sgf, tile))
    case("large", lambda: spatial.classify_large_scene_sharded(
        inp["lg_pre"], sgf, tile, stats_tile_rows=63))
    return out


def workflow_suite(workdir: str, world: int) -> dict:
    from rs_image_segmentation_tpu_torch.tools.batch import (
        run_batch_workflow)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    flat = tforest.flat_forest_from_numpy(_fields(inp, "ff_"))
    with open(os.path.join(workdir, "paths.json")) as f:
        paths = json.load(f)
    out = {}
    for name, scene_paths in paths.items():
        res = run_batch_workflow(scene_paths, flat, int(inp["ff_depth"]),
                                 os.path.join(workdir, f"{name}_w{world}"),
                                 mesh=make_mesh(device="cpu"), cfg=STACK_CFG)
        out[name] = np.array(json.dumps(res))
    return out


def main() -> None:
    suite, rank, world, store, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.init_multihost(f"file://{store}", world, rank,
                             backend="gloo", device="cpu")
    if suite == "parallel":
        out = parallel_suite(np.load(os.path.join(workdir, "inputs.npz")),
                             world)
    else:
        out = workflow_suite(workdir, world)
    np.savez(os.path.join(workdir, f"w{world}_r{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

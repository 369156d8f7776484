"""The port's KMeans batch program against the benchmark's plain reference
of the source's KMeans (``perfbench/reference/kmeans.py``), on the CPU at
2 tiles x 96 x 96 of two content seeds, with the cell
``tile600-kmeans-batch``'s settings (k 7, seed 42, every pixel, tol 1e-4,
max_iter 300).

The maps go through the comparison that decides the cell's ``correct``
(``perfbench/harness/check.py``); the Lloyd iterations are compared tile by
tile; the reference in bfloat16 (the control) is rejected by the same
comparison; and the reference loads neither package nor JAX."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import check, manifest, setup
from perfbench.harness.trace import Tracer
from perfbench.inputs import scenes as scene_gen
from perfbench.loops import kmeans_batch_loop
from perfbench.reference import kmeans as ref
from perfbench.reference import landcover
from rs_image_segmentation_tpu_torch.models import kmeans
from rs_image_segmentation_tpu_torch.pipeline import preprocess, turbo

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CELL = "tile600-kmeans-batch"
SIDE = 96
SEEDS = (42, 43)        # the cell's content seed, and the next
# The cell's limit (1e-2) is a share of a 600 x 600 tile, set between the
# program's and the control's readings at that size. At 96 x 96 one pixel
# is 1.1e-4 of a tile and the control moves fewer pixels (2e-3 to 3e-2 of
# a tile on these seeds), so the comparison here takes nine pixels (1e-3)
# in its place, as the benchmark's own CPU runs do
# (perfbench/tests/conftest.py::small). The port's stack differs from the
# reference's by float32 rounding (up to 2.2e-5 after scaling, in std5),
# which moves a few pixels on cluster boundaries: 5 of 9216 on seed 42's
# second tile with 4 CPU threads.
SMALL_LIMIT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """A fixed thread count keeps the CPU matmuls' summation order, and
    other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ctx():
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, CELL)
    cfg = manifest.config(bench, cell["config"])
    cfg["tile"] = {"height": SIDE, "width": SIDE}
    cfg["scene"].update(height=SIDE, width=SIDE)
    traffic = manifest.traffic(cell["traffic"])
    traffic["limits"]["worst_mismatch_share"] = SMALL_LIMIT
    return setup.Context(cell=cell, cfg=cfg, traffic=traffic, seed=0,
                         seconds=0.0, dev=CPU, tracer=Tracer(False, 1.0))


@pytest.fixture(scope="module", params=SEEDS)
def run(request, ctx):
    """One content seed's tiles, the port's maps and per-tile Lloyd
    iterations, and the reference's labels and iterations."""
    cfg, km = ctx.cfg, ctx.cfg["kmeans"]
    pool = scene_gen.synthetic_pool(2, SIDE, SIDE, request.param, CPU)
    cal = cfg["calibration"]
    luts = np.stack([preprocess.build_stretch_lut(
        s, np.asarray(cal["gains"]), np.asarray(cal["biases"]))
        for s in pool]).astype(np.uint8)
    feat = kmeans_batch_loop._feature_config(cfg)
    maps = turbo.kmeans_scenes_turbo_batch(
        pool, luts, km["n_clusters"], feat, seed=km["seed"],
        fit_stride=km["fit_stride"], device=CPU).numpy()
    xs = turbo.kmeans_features(torch.from_numpy(pool),
                               torch.from_numpy(luts), feat)
    _, _, iters = turbo.kmeans_fit(xs, km["n_clusters"], km["seed"],
                                   km["fit_stride"], False)
    fits = [ref.fit(s, cfg, CPU) for s in pool]
    return {"seed": request.param, "pool": pool, "luts": luts, "maps": maps,
            "iters": iters.tolist(), "ref": fits}


def test_maps_pass_the_cells_comparison(ctx, run):
    inputs = dict(enumerate(run["pool"]))
    r = check.compare(ctx, list(enumerate(run["maps"])), inputs, 0, None, 0)
    assert r["correct"] is True and r["compared"] == 2, r
    # every pixel of every iteration, and the final assignment
    k, f = ctx.cfg["kmeans"]["n_clusters"], 19
    assert r["ops_per_pixel"] > 2 * k * f + 2 * f * (k - 1)


def _parting(run, cfg):
    """Each tile's Lloyd paths stepped side by side, the port's batched
    step (``models.kmeans._lloyd``, as ``fit_centroids`` runs it) on the
    port's features and the reference's step on its own, from their own
    k-means++ picks: ``(iteration, gaps)`` where the labels first differ,
    ``gaps`` the parting pixels' second-nearest less nearest squared
    distance (the reference's), or None if they never part within the
    shorter fit."""
    km = cfg["kmeans"]
    k = km["n_clusters"]
    xs = turbo.kmeans_features(torch.from_numpy(run["pool"]),
                               torch.from_numpy(run["luts"]),
                               kmeans_batch_loop._feature_config(cfg))
    xb = xs.transpose(1, 2).contiguous()
    cp = kmeans.kmeans_plus_plus_init(
        xb, k, torch.Generator().manual_seed(km["seed"]))
    xn = torch.sum(xb * xb, dim=-1, keepdim=True)
    xr = [ref.minmax(landcover.stack(s, cfg, CPU).reshape(19, -1)).T
          for s in run["pool"]]
    cr = [ref.plus_plus(x, k, ref.gumbel(km["seed"], k, x.shape[0]))
          for x in xr]
    out = [None] * len(xr)
    for it in range(max(min(a, b[1]) for a, b in zip(run["iters"],
                                                     run["ref"]))):
        new, labels, _ = kmeans._lloyd(xb, cp, xn)
        for i, x in enumerate(xr):
            if out[i] is not None or it >= min(run["iters"][i],
                                               run["ref"][i][1]):
                continue
            d = labels[i] != ref.nearest(x, cr[i])
            if d.any():
                dist = torch.sum((x[d][:, None] - cr[i][None]) ** 2, dim=-1)
                two = torch.topk(dist, 2, largest=False).values
                out[i] = (it, (two[:, 1] - two[:, 0]).tolist())
            cr[i] = ref.lloyd(x, cr[i], 0.0, 1)[0]
        cp = new
    return out


# A tie at float32 rounding: the scaled features of the two stacks differ
# by up to 2.2e-5 (std5), which moves a pixel's squared distance to a
# centroid by about 1e-4 at most; the paths part at gaps of 6e-8 to 1.3e-6
# (seeds 42 and 43 at 2 and 4 CPU threads), where a cluster's own gaps run
# from 1e-2 up.
TIE = 1e-4


def test_lloyd_iterations_of_each_tile(ctx, run):
    """The port's count of each tile equals the reference's while their
    paths stay together. Where the paths part (the labels of some
    iteration differ), the parting pixels must be ties within the two
    stacks' and sums' float32 rounding; a count that then differs is
    named in a warning."""
    ref_iters = [it for _, it, _, _ in run["ref"]]
    for i, parted in enumerate(_parting(run, ctx.cfg)):
        a, b = run["iters"][i], ref_iters[i]
        if parted is None:
            assert a == b, (i, a, b)
            continue
        it, gaps = parted
        assert 0 < len(gaps) <= 3 and max(gaps) <= TIE, (i, parted)
        if a != b:
            warnings.warn(f"content seed {run['seed']}, tile {i}: the port "
                          f"stops after {a} Lloyd iterations, the "
                          f"reference after {b}; their paths part at "
                          f"iteration {it + 1} on ties {gaps}")


def test_control_is_rejected_by_the_comparison(ctx, run):
    inputs = dict(enumerate(run["pool"]))
    control = [(i, ref.kmeans_labels(s, ctx.cfg, None, 0, CPU,
                                     store_dtype=torch.bfloat16)[0])
               for i, s in inputs.items()]
    r = check.compare(ctx, control, inputs, 0, None, 0)
    assert r["correct"] is False, r
    worst = r["numbers"]["worst_mismatch_share"]
    assert worst["value"] > worst["limit"]


def test_reference_loads_neither_package_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import perfbench.reference.kmeans; "
            "print(' '.join(sorted(m for m in sys.modules if "
            "m.split('.')[0] in sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), "jax",
                          "jaxlib", "flax", "rs_image_segmentation_tpu",
                          "rs_image_segmentation_tpu_torch"],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == ""

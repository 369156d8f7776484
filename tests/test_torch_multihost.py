"""PyTorch port, on the CPU: the multi-process rehearsal
(``parallel.multihost``, its worker and ``rs-seg-torch-multihost-rehearse``)
and ``tools.batch.run_batch_workflow`` over a mesh, mirroring the JAX
package's ``test_multihost.py`` and ``test_batch_workflow_on_mesh``.

Ranks are spawned processes on gloo (``device="cpu"``, one intra-op
thread) that meet through a ``file://`` store, one group per case, all
started before the in-process references run; the JAX workflow runs here
on conftest's 8 virtual CPU devices."""

import ast
import filecmp
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    FeatureStageConfig as JFeatureStageConfig)
from rs_image_segmentation_tpu.core.config import GLCMConfig as JGLCMConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.parallel.mesh import make_mesh as jmake_mesh
from rs_image_segmentation_tpu.tools import batch as jbatch
from rs_image_segmentation_tpu_torch.cli.multihost_cli import (
    multihost_rehearse_cli)
from rs_image_segmentation_tpu_torch.core.config import (FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.parallel import mesh as tmesh
from rs_image_segmentation_tpu_torch.parallel.multihost import (
    init_multihost)
from rs_image_segmentation_tpu_torch.tools.batch import run_batch_workflow
from rs_image_segmentation_tpu_torch.tools.fixtures import synthetic_scenes

from .test_torch_parallel import collect, spawn

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_MODULE = "rs_image_segmentation_tpu_torch.parallel.multihost_worker"
CASES = [(2, "even"), (3, "even"), (2, "uneven")]
RANK_TIMEOUT_S = 240
CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=16, step_size=16,
                                         levels=8))
JCFG = JFeatureStageConfig(glcm=JGLCMConfig(window_size=16, step_size=16,
                                            levels=8))


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def rehearsals(tmp_path_factory):
    """The worker groups of CASES, started together: {case: [Popen]}."""
    root = tmp_path_factory.mktemp("multihost")
    out = {}
    for nproc, mode in CASES:
        store = f"file://{root}/store_{nproc}_{mode}"
        out[(nproc, mode)] = [subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE, str(pid), str(nproc),
             store, "2", mode, "--device", "cpu", "--backend", "gloo"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(), cwd=PORT) for pid in range(nproc)]
    return out


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """Eight 48 x 48 GeoTIFFs of uint8 DNs (the turbo route) and two of
    16-bit DNs (the streamed route), a 10-tree forest trained by the
    JAX package, and the workflow's rank groups at 1 and 2 ranks."""
    root = tmp_path_factory.mktemp("workflow")
    rng = np.random.default_rng(0)
    scenes = synthetic_scenes(8, 48, 48, seed=9)
    paths = {"u8": [], "u16": []}
    for i, s in enumerate(scenes):
        paths["u8"].append(str(root / f"s{i}.tif"))
        write_tiff(paths["u8"][-1], s)
    for i, s in enumerate(scenes[:2]):
        paths["u16"].append(str(root / f"d{i}.tif"))
        write_tiff(paths["u16"][-1], s.astype(np.uint16) * 40 + 7)
    x = rng.random((60, 19)).astype(np.float32)
    flat, depth = jforest.fit_random_forest(x, rng.integers(1, 4, 60),
                                            n_estimators=10, seed=0)
    fields = {f"ff_{k}": np.asarray(v) for k, v in flat._asdict().items()}
    np.savez(root / "inputs.npz", ff_depth=np.array(depth), **fields)
    with open(root / "paths.json", "w") as f:
        json.dump(paths, f)
    groups = spawn("workflow", str(root), (1, 2))
    return root, paths, flat, depth, groups


def _drain(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    return outs


@pytest.mark.parametrize("nproc,mode", CASES)
def test_global_mesh_classify(rehearsals, nproc, mode):
    """Each rank's maps bit-equal to the one-process turbo program on its
    scenes (the worker raises otherwise)."""
    procs = rehearsals[(nproc, mode)]
    outs = _drain(procs)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK {pid} mode={mode}" in out, out[-3000:]
    if mode == "uneven":   # rank 0 carried 3 true scenes, rank 1 one
        assert "local=3" in outs[0] and "local=1" in outs[1]


def test_worker_failure_fails_loudly_and_kills_peers(monkeypatch):
    """One rank exits right after joining; the rehearsal CLI must surface
    a non-zero exit and end the peer (which would otherwise wait in a
    collective) well inside the run's budget."""
    monkeypatch.setenv("RS_SEG_MULTIHOST_FAIL_PID", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(PORT)
    t0 = time.monotonic()
    rc = multihost_rehearse_cli(["--nproc", "2", "--device", "cpu",
                                 "--timeout", "120"])
    took = time.monotonic() - t0
    assert rc == 3          # the failing rank's own exit code
    assert took < 60, f"failure took {took:.0f}s to surface"


def test_nccl_without_a_card_raises_its_reason():
    with pytest.raises(ValueError, match="NCCL backend runs on CUDA"):
        tmesh.check_backend("nccl", torch.device("cpu"), 1)
    # two ranks and no card (or one): NCCL refuses two ranks on one GPU
    with pytest.raises(RuntimeError, match="NCCL takes one CUDA device a "
                                           "rank: 2 ranks"):
        init_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="not one of"):
        tmesh.check_backend("mpi", torch.device("cpu"), 1)


def test_rehearsal_cli_nccl_on_the_cpu_fails(monkeypatch, capfd):
    monkeypatch.chdir(PORT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = multihost_rehearse_cli(["--nproc", "2", "--device", "cpu",
                                 "--backend", "nccl", "--timeout", "120"])
    assert rc != 0
    assert "NCCL backend runs on CUDA devices" in capfd.readouterr().err


def test_block_bounds_split_like_array_split():
    for n, parts in ((8, 3), (10, 4), (3, 4), (12, 4)):
        want = np.array_split(np.arange(n), parts)
        for i in range(parts):
            lo, hi = tmesh.block_bounds(n, parts, i)
            assert np.array_equal(np.arange(n)[lo:hi], want[i])


def _maps(results):
    return [read_tiff(r["class_map"])[0][0] for r in results]


def test_batch_workflow_on_mesh(workflow, tmp_path):
    """Every rank returns the whole list in scene order; the files equal
    the ``mesh=None`` run's byte for byte, on both routes, at 1 and 2
    ranks; the maps equal JAX's workflow on its 8-device mesh on >= 99.9 %
    of pixels (the reference's contract)."""
    root, paths, flat, depth, groups = workflow
    tflat = tforest.flat_forest_from_numpy(
        {k: np.asarray(v) for k, v in flat._asdict().items()})
    jout = jbatch.run_batch_workflow(paths["u8"], flat, depth,
                                     str(tmp_path / "jax"),
                                     mesh=jmake_mesh(axis_names=("data",)),
                                     cfg=JCFG)
    ranks = collect(groups, str(root))
    refs = {}
    for name, scene_paths in paths.items():
        refs[name] = run_batch_workflow(scene_paths, tflat, depth,
                                        str(tmp_path / name), cfg=CFG,
                                        device="cpu")
        for world in (1, 2):
            lists = [json.loads(str(r[name])) for r in ranks[world]]
            assert all(lst == lists[0] for lst in lists)
            assert [e["scene"] for e in lists[0]] == scene_paths
            for got, want in zip(lists[0], refs[name]):
                assert filecmp.cmp(got["class_map"], want["class_map"],
                                   shallow=False), (world, got)
    agree = (np.stack(_maps(refs["u8"])) == np.stack(_maps(jout))).mean()
    assert agree >= 0.999, agree


def test_parallel_modules_import_no_jax():
    pkg = os.path.join(PORT, "rs_image_segmentation_tpu_torch")
    files = glob.glob(os.path.join(pkg, "parallel", "*.py")) + [
        os.path.join(pkg, "cli", "multihost_cli.py"),
        os.path.join(pkg, "tools", "batch.py")]
    assert len(files) >= 11
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib",
                                    "rs_image_segmentation_tpu"), (path,
                                                                   name)

"""repro_torch and chip_smoke.py stand alone: they import neither jax nor
the reference package ``repro``."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    script = (
        "import importlib, json, sys\n"
        f"for name in {['repro_torch'] + _modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_module_list_covers_the_slice():
    mods = set(_modules())
    for name in ("device", "core.frame", "core.pipeline", "core.measures",
                 "core.experiment", "ir.tokenizer", "ir.corpus", "ir.index",
                 "ir.dense", "models.common", "models.cross_encoder",
                 "caching.bucketing", "kernels._build",
                 "kernels.dense_topk.kernel", "kernels.dense_topk.ops",
                 "kernels.dense_topk.ref", "core.ir", "core.rewrite",
                 "core.cost", "core.executor", "core.precompute",
                 "core.plan", "caching.provenance", "caching.auto",
                 "caching.backends", "caching.economics",
                 "caching.codecs", "caching.base", "caching.kv",
                 "caching.scorer", "caching.tiered", "caching.retriever",
                 "caching.dense", "caching.indexer", "caching.lazy",
                 "caching.artifact", "core.compile_opt",
                 "kernels.cachekey_hash.kernel",
                 "kernels.cachekey_hash.ops", "kernels.cachekey_hash.ref",
                 "kernels.bm25_block.kernel", "kernels.bm25_block.ops",
                 "kernels.bm25_block.ref", "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops",
                 "kernels.flash_attention.ref",
                 "kernels.embedding_bag.kernel", "kernels.embedding_bag.ops",
                 "kernels.embedding_bag.ref"):
        assert f"repro_torch.{name}" in mods


SERVING_SLICE = ("caching.dataplane", "caching.mmap_tier", "caching.warming",
                 "serve", "serve.registry", "serve.service", "serve.config",
                 "launch", "launch.serve", "cli", "cli.__main__", "cli.plan",
                 "cli.serve")

#: the fleet, its fault policy and checkpointer, and the cache CLI
FLEET_SLICE = ("distrib", "distrib.checkpoint", "distrib.fault",
               "serve.fleet", "cli.cache")

#: the CUDA-graph memo, the LM family and smollm-360m's config
LM_SLICE = ("caching.compile_cache", "models.lm", "configs",
            "configs.smollm_360m")

#: the recsys and GCN families, their configs, and the training stack
TRAIN_SLICE = ("models", "models.recsys", "models._jax_threefry",
               "models.gcn", "configs.mind", "configs.dlrm_rm2",
               "configs.dcn_v2", "configs.two_tower_retrieval",
               "configs.gcn_cora", "distrib.compression", "train",
               "train.schedule", "train.optimizer", "train.loop", "data",
               "data.pipeline")

#: the distribution layer, the architecture registry and the launchers
DIST_SLICE = ("distrib.shardings", "launch.mesh", "launch.roofline",
              "launch.dryrun", "launch.train", "configs.base",
              "configs.registry", "configs.granite_moe_3b_a800m",
              "configs.phi35_moe_42b_a66b", "configs.qwen15_110b",
              "configs.qwen3_14b")


def test_every_reference_module_has_a_counterpart():
    """The module lists of ``src/repro`` and ``src/repro_torch`` agree:
    no module of the reference is left without one in the port."""
    def names(root):
        return {str(p.relative_to(root)) for p in root.rglob("*.py")}
    assert names(ROOT / "src" / "repro") - names(PKG) == set()


@pytest.mark.parametrize("name", SERVING_SLICE + FLEET_SLICE + LM_SLICE
                         + TRAIN_SLICE + DIST_SLICE)
def test_serving_slice_modules_are_listed_and_stand_alone(name):
    """Each module of the serving and fleet slices exists, and importing
    it alone in a fresh interpreter pulls in neither jax nor repro."""
    assert f"repro_torch.{name}" in set(_modules())
    script = (
        "import importlib, json, sys\n"
        f"importlib.import_module('repro_torch.{name}')\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "torch_profile_main_path.py",
                            ROOT / "tools" / "torch_lm_bf16_drift.py",
                            ROOT / "examples" / "train_reranker_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert not _imported_roots(path) & set(FORBIDDEN)

"""repro_torch.data against repro.data: the step-keyed batches of every
generator are byte-equal to the reference's (dtypes and shapes too), a
step's batch is a pure function of (seed, step), and shards of a step
compose to its global batch.  Pure numpy on both sides, so exact."""
import numpy as np
import pytest
import torch

from repro.configs.dcn_v2 import CONFIG as J_DCN
from repro.configs.dlrm_rm2 import CONFIG as J_DLRM
from repro.configs.mind import CONFIG as J_MIND
from repro.configs.two_tower_retrieval import CONFIG as J_TT
from repro.data import pipeline as JD
from repro.models.gcn import NeighborSampler as JSampler
from repro_torch.configs.dcn_v2 import CONFIG as T_DCN
from repro_torch.configs.dlrm_rm2 import CONFIG as T_DLRM
from repro_torch.configs.mind import CONFIG as T_MIND
from repro_torch.configs.two_tower_retrieval import CONFIG as T_TT
from repro_torch.data import pipeline as TD
from repro_torch.models.gcn import NeighborSampler as TSampler

torch.set_num_threads(1)

RECSYS = {"dlrm": (J_DLRM, T_DLRM), "dcn": (J_DCN, T_DCN),
          "mind": (J_MIND, T_MIND), "two_tower": (J_TT, T_TT)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _gcn_gens():
    rng = np.random.default_rng(0)
    N, E = 100, 500
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    feats = rng.normal(size=(N, 8)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    return (JD.gcn_sampled(JSampler.from_edges(N, src, dst), feats, labels,
                           (5, 3)),
            TD.gcn_sampled(TSampler.from_edges(N, src, dst), feats, labels,
                           (5, 3)))


def _gens(family):
    if family == "lm":
        return JD.lm_synthetic(1000, 32), TD.lm_synthetic(1000, 32)
    if family == "gcn":
        return _gcn_gens()
    j, t = RECSYS[family]
    return JD.recsys_synthetic(j), TD.recsys_synthetic(t)


FAMILIES = ["lm", "gcn"] + sorted(RECSYS)


@pytest.mark.parametrize("family", FAMILIES)
def test_batches_are_byte_equal(family):
    jgen, tgen = _gens(family)
    jds = JD.StepKeyedDataset(jgen, global_batch=16, seed=3)
    tds = TD.StepKeyedDataset(tgen, global_batch=16, seed=3)
    for step in (0, 1, 7, 1000):
        _same(tds.batch(step), jds.batch(step))
        _same(tds(step), tds.batch(step))          # pure in (seed, step)
    assert TD._rng(3, 7).integers(0, 2**31, 4).tobytes() == \
        JD._rng(3, 7).integers(0, 2**31, 4).tobytes()


@pytest.mark.parametrize("family", FAMILIES)
def test_shards_compose_to_the_global_batch(family):
    jgen, tgen = _gens(family)
    tds = TD.StepKeyedDataset(tgen, global_batch=32, seed=0)
    jds = JD.StepKeyedDataset(jgen, global_batch=32, seed=0)
    full = tds.batch(5)
    parts = [tds.shard(i, 4).batch(5) for i in range(4)]
    for k, v in full.items():
        assert np.array_equal(np.concatenate([p[k] for p in parts]), v)
    for i in range(4):
        _same(parts[i], jds.shard(i, 4).batch(5))
    assert not np.array_equal(
        next(iter(tds.batch(6).values())), next(iter(full.values())))


def test_recsys_schemas_at_full_width():
    for j, t in RECSYS.values():
        b = TD.StepKeyedDataset(TD.recsys_synthetic(t), global_batch=8,
                                seed=1).batch(0)
        if t.kind in ("dlrm", "dcn"):
            assert b["sparse"].shape == (8, t.n_sparse)
            assert (b["sparse"].max(axis=0) < np.array(t.vocab_sizes)).all()
        elif t.kind == "mind":
            assert b["hist_ids"].shape == (8, t.hist_len)
        else:
            assert b["user_ids"].shape == (8,)
    assert set(JD.__all__) == set(TD.__all__)

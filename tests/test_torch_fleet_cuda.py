"""The serving fleet and the checkpointer on the card: worker processes
that each serve on ``cuda:0`` and launch the hand-written kernels
there, with results equal to an offline run, and a checkpoint restored
onto the card by default.  Imports neither jax nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py

Every test skips without a CUDA device."""
import pytest
import torch

from repro_torch.core import ExecutionPlan
from repro_torch.distrib import restore_checkpoint, save_checkpoint
from repro_torch.serve import FleetService, ServeConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_fleet_workers_serve_on_the_card_through_the_kernels(cuda):
    cfg = ServeConfig(pipeline="hybrid", scale=0.02, cutoff=5,
                      max_batch=4, workers=2, warm_start=False)
    scenario = cfg.build_scenario()
    offline = ExecutionPlan([scenario.pipeline]).run(scenario.topics)[0][0]
    want = {str(k[0]): offline.take(i)
            for k, i in offline.group_indices(["qid"]).items()}
    rows = list(zip([str(q) for q in scenario.topics["qid"].tolist()],
                    scenario.topics["query"].tolist()))
    with FleetService(cfg) as svc:
        futs = [(q, svc.submit(q, t)) for q, t in rows]
        for qid, fut in futs:
            got = fut.result(120)
            assert sorted(got["docno"].tolist()) == \
                sorted(want[qid]["docno"].tolist()), qid
            g = dict(zip(got["docno"].tolist(), got["score"].tolist()))
            for d, s in zip(want[qid]["docno"].tolist(),
                            want[qid]["score"].tolist()):
                assert abs(g[d] - s) <= 1e-5 * max(abs(s), 1e-30)
        report = svc.drain()
    assert set(report["exit_codes"].values()) == {0}
    for w in report["workers"]:
        assert w["device"] == "cuda:0"
        assert w["kernel_launches_at_start"]["cachekey_hash"] >= 1
        assert w["kernel_launches"]["dense_topk"] >= 1


def test_checkpoint_restores_onto_the_card_by_default(cuda, tmp_path):
    tree = ({"w": torch.arange(8, dtype=torch.bfloat16, device="cuda")},
            {"step": torch.tensor(3, device="cuda")})
    save_checkpoint(str(tmp_path), 1, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 1 and got[0]["w"].is_cuda and got[1]["step"].is_cuda
    assert got[0]["w"].dtype == torch.bfloat16
    assert torch.equal(got[0]["w"], tree[0]["w"])

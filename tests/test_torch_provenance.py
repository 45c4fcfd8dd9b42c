"""Provenance parity: the port's canonical encoding, digests, manifests
and stale-cache policies equal the reference's (``repro.caching``), and
plan-node fingerprints fall into the same equivalence classes.

The CPU tests ask for the CPU digest through the port's own setting
(``set_digest_device("cpu")``), never through the reference's
``REPRO_PROVENANCE_HASH``."""
import json
import os

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.caching.provenance as jprov
import repro.core as jcore
import repro.ir as jir
import repro_torch.caching as tcache
import repro_torch.caching.provenance as tprov
import repro_torch.core as tcore
import repro_torch.ir as tir
from _torch_parity import fp_classes, pipeline_sets, toy

torch.set_num_threads(1)
tprov.set_digest_device("cpu")

PAYLOADS = [
    (), [], {}, set(), b"", "", None, True, False, 0, -1, 2**70, -2**63,
    1.5, -0.0, float("inf"), 1e-300, np.int64(7), np.int32(-3),
    np.uint8(255), np.float32(0.1), np.float64(2.5), b"\x00\xff\x10",
    bytearray(b"ab"), "ünïcödé", ("a", 1, 2.0, None),
    (1, (2, (3, (4, ())))), [1, "a", b"b", [2.5, {"k": 1}]],
    {"b": 1, "a": (2, 3), 3: "x"}, {3, 1, 2}, frozenset({"x", "y"}),
    {"nested": [{"k": {1, 2}}, ("t", frozenset())]},
    ("transformer/v1", "mod", "Cls", "", ("Sig", 3, ("In", 1.0)), ()),
]


@pytest.mark.parametrize("obj", PAYLOADS, ids=lambda o: type(o).__name__)
def test_canonical_bytes_and_combine_equal_reference(obj):
    assert tprov.canonical_bytes(obj) == jprov.canonical_bytes(obj)
    assert tprov.combine_fingerprints("node", obj) == \
        jprov.combine_fingerprints("node", obj)


@pytest.mark.parametrize("size", [0, 1, 3, 4, 247, 248, 249, 1000])
def test_digest_bytes_equals_reference(size):
    data = np.random.default_rng(size).bytes(size)
    assert tprov.digest_bytes(data) == jprov.digest_bytes(data)


def test_digest_equals_host_loop_on_random_payloads():
    rng = np.random.default_rng(1)
    for _ in range(12):
        data = rng.bytes(int(rng.integers(0, 3000)))
        buf = len(data).to_bytes(8, "little") + data
        buf += b"\x00" * ((-len(buf)) % 4)
        words = np.frombuffer(buf, dtype="<u4")
        words = np.concatenate([words, np.zeros((-len(words)) % 64,
                                                dtype="<u4")])
        want = tprov._host_digest(words)
        assert want == jprov._host_digest(words)
        assert tprov.digest_bytes(data) == want.hex()


def test_digest_device_setting():
    assert tprov.set_digest_device("cpu") == "cpu"
    with pytest.raises(ValueError):
        tprov.set_digest_device("tpu")
    assert tprov.set_digest_device("cpu") == "cpu"


def test_fingerprints_stable_config_and_weight_sensitive():
    assert tir.QueryExpander(2).fingerprint() == \
        tir.QueryExpander(2).fingerprint()
    assert tir.QueryExpander(2).fingerprint() != \
        tir.QueryExpander(3).fingerprint()
    fp = tir.QueryExpander(2).fingerprint()
    assert len(fp) == 16 and int(fp, 16) >= 0
    from repro_torch.models.cross_encoder import EncoderConfig, MonoScorer
    cfg = EncoderConfig(name="torch-prov", n_layers=1, d_model=16,
                        n_heads=2, d_ff=32, vocab_size=64, max_len=8)
    native = MonoScorer(cfg, seed=0, device="cpu")
    tree = {k: v.numpy() for k, v in native.encoder.top.items()}
    tree["layers"] = {k: v.numpy() for k, v in native.encoder.layers.items()}
    bridged = MonoScorer(cfg, seed=0, params=tree, device="cpu")
    # equal weights, equal signature — but a cache never mixes the two
    assert native.signature() == bridged.signature()
    assert native.fingerprint_extras() == ("weights", "torch.Generator", 0)
    assert bridged.fingerprint_extras()[:2] == ("weights", "numpy-sha256")
    assert native.fingerprint() != bridged.fingerprint()
    assert bridged.fingerprint() == MonoScorer(
        cfg, params=tree, device="cpu").fingerprint()


# -- manifests ----------------------------------------------------------------

def test_manifest_roundtrip_both_ways(tmp_path):
    for save_mod, load_mod in ((tprov, jprov), (jprov, tprov),
                               (tprov, tprov)):
        d = tmp_path / f"{save_mod.__name__}-{load_mod.__name__}"
        d.mkdir()
        m = save_mod.CacheManifest.new(
            family="KeyValueCache", backend="sqlite", fingerprint="aa" * 8,
            key_columns=["qid"], value_columns=["query"],
            codec="kv-fnv128-pack1")
        m.entry_count = 7
        m.save(str(d))
        loaded = load_mod.CacheManifest.load(str(d))
        assert loaded.body() == m.body()


def test_manifest_checksum_detects_hand_edit(tmp_path):
    m = tprov.CacheManifest.new(family="KeyValueCache", backend="sqlite",
                                fingerprint="deadbeefdeadbeef")
    m.save(str(tmp_path))
    p = tmp_path / "manifest.json"
    p.write_text(p.read_text().replace("deadbeefdeadbeef",
                                       "deadbeefdeadbee0"))
    for mod in (tprov, jprov):
        with pytest.raises(mod.ManifestError, match="checksum"):
            mod.CacheManifest.load(str(tmp_path))


def test_manifest_rejects_future_format_version(tmp_path):
    m = tprov.CacheManifest.new(family="X")
    m.format_version = tprov.MANIFEST_VERSION + 1
    m.save(str(tmp_path))
    for mod in (tprov, jprov):
        with pytest.raises(mod.ManifestError, match="format_version"):
            mod.CacheManifest.load(str(tmp_path))
    assert tprov.CacheManifest.load(str(tmp_path / "absent")) is None


def test_v1_manifest_adopts_v2_schema(tmp_path):
    m = tprov.CacheManifest.new(family="KeyValueCache", backend="sqlite",
                                fingerprint="bb" * 8)
    doc = m.body()
    doc["format_version"] = 1
    for k in ("max_entries", "max_bytes", "ttl_seconds"):
        del doc[k]
    assert tprov._body_checksum(doc) == jprov._body_checksum(doc)
    doc["checksum"] = tprov._body_checksum(doc)
    with open(os.path.join(tmp_path, "manifest.json"), "w") as f:
        json.dump(doc, f)
    loaded = tprov.CacheManifest.load(str(tmp_path))
    assert loaded.format_version == 1 and not loaded.has_budget()
    loaded.save(str(tmp_path))                   # upgrade-on-write
    assert tprov.CacheManifest.load(str(tmp_path)).format_version == \
        tprov.MANIFEST_VERSION == jprov.MANIFEST_VERSION
    assert jprov.CacheManifest.load(str(tmp_path)).format_version == 2


# -- stale-cache policies, same directory, both packages ------------------------

def _kv(pkg_cache, path, t, **kw):
    return pkg_cache.KeyValueCache(path, t, key=("qid", "query"),
                                   value=("query",), **kw)


def _queries(core):
    return core.ColFrame({"qid": ["q1", "q2", "q3"],
                          "query": ["alpha beta", "gamma delta", "eps"]})


def _filled(tmp_path, name):
    """A directory filled by the reference, fingerprint "aa"*8."""
    d = str(tmp_path / name)
    with _kv(jcache, d, jir.QueryExpander(2), fingerprint="aa" * 8) as kv:
        kv(_queries(jcore))
    return d


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_on_stale_policies_on_one_directory(tmp_path, pkg):
    cache, core, ir = (jcache, jcore, jir) if pkg == "reference" \
        else (tcache, tcore, tir)
    d = _filled(tmp_path, "stale")
    with pytest.raises(cache.StaleCacheError, match="fingerprint"):
        _kv(cache, d, ir.QueryExpander(3), fingerprint="bb" * 8)
    with _kv(cache, d, ir.QueryExpander(3), fingerprint="bb" * 8,
             on_stale="readonly") as kv:
        assert kv.readonly
        out = kv(_queries(core))
        assert kv.stats.hits == 3 and kv.stats.misses == 0
        assert out["query"][0] == \
            ir.QueryExpander(2)(_queries(core))["query"][0]
    with _kv(cache, d, ir.QueryExpander(3), fingerprint="bb" * 8,
             on_stale="recompute") as kv:
        assert len(kv) == 0
        out = kv(_queries(core))
        assert kv.stats.misses == 3
        assert out["query"][0] == \
            ir.QueryExpander(3)(_queries(core))["query"][0]
    m = jprov.CacheManifest.load(d)
    assert m.fingerprint == "bb" * 8 and m.entry_count == 3


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_tampered_manifest_policies(tmp_path, pkg):
    cache, core, ir = (jcache, jcore, jir) if pkg == "reference" \
        else (tcache, tcore, tir)
    d = _filled(tmp_path, "tampered")
    p = os.path.join(d, "manifest.json")
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace('"entry_count": 3', '"entry_count": 4'))
    with pytest.raises(cache.ManifestError, match="checksum"):
        _kv(cache, d, ir.QueryExpander(2), fingerprint="aa" * 8)
    with _kv(cache, d, ir.QueryExpander(2), fingerprint="aa" * 8,
             on_stale="recompute") as kv:
        assert len(kv) == 0
        kv(_queries(core))
        assert kv.stats.misses == 3
    assert jprov.CacheManifest.load(d).entry_count == 3


# -- plan-node fingerprints ----------------------------------------------------

@pytest.mark.parametrize("optimize", ["none", "all"])
@pytest.mark.parametrize("name", ["ablation", "commutative", "cutoffs",
                                  "mixed"])
def test_node_fingerprint_classes_equal_reference(name, optimize):
    jp = pipeline_sets(toy(jcore))[name]
    tp = pipeline_sets(toy(tcore))[name]
    jplan = jcore.ExecutionPlan(jp, optimize=optimize)
    tplan = tcore.ExecutionPlan(tp, optimize=optimize)
    jf, tf = jplan.node_fingerprints(), tplan.node_fingerprints()
    assert sorted(jf) == sorted(tf)
    assert fp_classes(jf) == fp_classes(tf)
    assert [n.label for n in jplan.graph.nodes] == \
        [n.label for n in tplan.graph.nodes]

"""The arithmetic the metric readers share, one function per quantity.

``m`` is the run's ``harness.Measured``: ``counters`` are the program's
own counts over the window, ``spans`` the benchmark's host-clock spans
and counts around the calls into each layer (traced runs only), and
``device`` the reading of the device trace (traced runs on the card
only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench.metrics.peaks import FLOAT32_FLOPS


def _ratio(a: float, b: float, scale: float = 1.0) -> Optional[float]:
    return a / b * scale if b else None


def setup_s(m):
    return m.setup_s


def exp_topics_per_s(m):
    return _ratio(m.counters.get("topics", 0), m.window_s)


def serve_latency_ms(m, q: float):
    lat = m.record.get("latencies_ms")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, q))


def plan_compile_ms(m):
    if m.spans is None:
        return None
    return _ratio(m.spans.seconds.get("plan_compile", 0.0),
                  m.counters.get("experiments", 0), 1e3)


def bm25_ms_per_topic(m):
    if m.spans is None:
        return None
    return _ratio(m.spans.seconds.get("bm25", 0.0),
                  m.spans.counts.get("bm25_topics", 0), 1e3)


def tokenize_us_per_pair(m):
    if m.spans is None:
        return None
    return _ratio(m.spans.seconds.get("tokenize", 0.0),
                  m.spans.calls.get("tokenize", 0), 1e6)


def encoder_ms_per_kpair(m):
    if m.device is None or not m.device["encoder_device_s"]:
        return None
    return _ratio(m.device["encoder_device_s"],
                  m.counters.get("pairs_encoded", 0), 1e6)


def useful_token_share(m):
    if m.spans is None:
        return None
    return _ratio(m.spans.counts.get("tokens_useful", 0.0),
                  m.spans.counts.get("tokens_computed", 0.0), 100.0)


def scorer_cache_hit_share(m):
    hits = m.counters.get("cache_hits", 0)
    return _ratio(hits, hits + m.counters.get("cache_misses", 0), 100.0)


def pairs_encoded_per_topic(m):
    return _ratio(m.counters.get("pairs_encoded", 0),
                  m.counters.get("topics", 0))


def requests_per_batch(m):
    return _ratio(m.counters.get("requests", 0),
                  m.counters.get("batches", 0))


def captures_in_window(m):
    return m.counters.get("compiles_in_window")


def encoder_roofline(m):
    if m.device is None or m.spans is None:
        return None
    return _ratio(m.spans.counts.get("encoder_least_s", 0.0),
                  m.device["encoder_device_s"], 100.0)


def mfu(m):
    if m.device is None or m.spans is None \
            or not m.spans.counts.get("encoder_flops"):
        return None
    return _ratio(m.spans.counts.get("encoder_flops", 0.0),
                  m.device["window_s"] * FLOAT32_FLOPS, 100.0)


def device_idle(m):
    if m.device is None or not m.device["busy_s"]:
        return None
    return 100.0 * (1.0 - m.device["busy_s"] / m.device["window_s"])

"""PyTorch/CUDA port of ``repro`` (the JAX/Pallas reference package).

Module names mirror the reference so each counterpart is easy to find:
``core`` (relations, operator algebra, measures, the plan compiler and
its executors, Experiment), ``ir`` (tokenizers, corpora, BM25, dense
retrieval), ``models`` (the cross-encoder), ``caching`` (the cache
families, their backends and tiers, the async data plane), ``serve``,
``cli`` and ``launch`` (single-process serving and its entry points)
and ``kernels`` (hand-written Hopper kernels with their plain PyTorch
versions).

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``).  This package never imports ``jax`` or
``repro``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

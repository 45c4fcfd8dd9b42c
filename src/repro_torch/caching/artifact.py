"""Artifact API — sharing caches across research groups (paper §4.5).

Counterpart of ``repro.caching.artifact``: the same tarball and
metadata layout in the same hub directory.

Cache objects serialize to a directory; the Artifact layer packages that
directory with a metadata record and pushes/pulls it to a *hub*.  The
paper uses HuggingFace / Zenodo; offline we implement the same API over
a local hub directory (``$REPRO_HUB`` or ``~/.repro_hub``) — the
network transport is the only thing stubbed, the packaging/metadata/
resolution logic is real.
"""
from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile
import time
from typing import Any, Dict, Optional, Type

__all__ = ["Artifact", "hub_dir", "to_hub", "from_hub"]


def hub_dir() -> str:
    d = os.environ.get("REPRO_HUB", os.path.expanduser("~/.repro_hub"))
    os.makedirs(d, exist_ok=True)
    return d


def _meta_of(obj: Any) -> Dict[str, Any]:
    return {
        "artifact_type": type(obj).__name__,
        "module": type(obj).__module__,
        "created": time.time(),
        "format_version": 1,
    }


def to_hub(obj: Any, repo_id: str) -> str:
    """Package ``obj.path`` (a cache directory) into the hub as a tarball."""
    path = getattr(obj, "path", None)
    if path is None or not os.path.isdir(path):
        raise ValueError(f"{obj!r} has no directory to share")
    if hasattr(obj, "_close_backend"):
        obj._close_backend()  # flush
    dest = os.path.join(hub_dir(), repo_id.replace("/", "__"))
    os.makedirs(dest, exist_ok=True)
    tar_path = os.path.join(dest, "artifact.tar")
    with tarfile.open(tar_path, "w") as tar:
        tar.add(path, arcname="artifact")
    with open(os.path.join(dest, "metadata.json"), "w") as f:
        json.dump(_meta_of(obj), f, indent=2)
    return dest


def from_hub(repo_id: str, dest_path: Optional[str] = None) -> str:
    """Fetch an artifact directory from the hub; returns the local path."""
    src = os.path.join(hub_dir(), repo_id.replace("/", "__"))
    tar_path = os.path.join(src, "artifact.tar")
    if not os.path.exists(tar_path):
        raise FileNotFoundError(f"artifact {repo_id!r} not found in hub "
                                f"{hub_dir()!r}")
    if dest_path is None:
        dest_path = tempfile.mkdtemp(prefix="repro-torch-artifact-")
    with tarfile.open(tar_path) as tar:
        if hasattr(tarfile, "data_filter"):
            tar.extractall(dest_path, filter="data")
        else:                            # pragma: no cover - old stdlib
            tar.extractall(dest_path)
    return os.path.join(dest_path, "artifact")


class Artifact:
    """Mixin/namespace mirroring the paper's ``pt.Artifact`` calls."""

    @staticmethod
    def from_hf(repo_id: str, cls: Optional[Type] = None, **kwargs):
        path = from_hub(repo_id)
        return cls(path, **kwargs) if cls is not None else path

    @staticmethod
    def from_zenodo(record_id: str, cls: Optional[Type] = None, **kwargs):
        path = from_hub(f"zenodo/{record_id}")
        return cls(path, **kwargs) if cls is not None else path


def _to_hf(self, repo_id: str) -> str:
    return to_hub(self, repo_id)


def _to_zenodo(self, record_id: str = "0") -> str:
    return to_hub(self, f"zenodo/{record_id}")


def install_artifact_methods(cls: Type) -> Type:
    """Grafts to_hf/to_zenodo onto a cache class (Artifact conformance)."""
    cls.to_hf = _to_hf
    cls.to_zenodo = _to_zenodo
    return cls

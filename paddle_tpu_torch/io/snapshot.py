"""The sha256 integrity manifest of a saved model directory.

Port of ``paddle_tpu/io/snapshot.py``'s ``write_file_manifest`` and
``verify_file_manifest``, with the same ``MANIFEST.json`` schema
(``{"version": 1, "files": {name: {"sha256", "bytes"}}}``), so either
package verifies the other's saved inference models.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

from .serialization import fsync_dir

__all__ = ["MANIFEST_NAME", "write_file_manifest", "verify_file_manifest"]

MANIFEST_NAME = "MANIFEST.json"


def _sha256_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    nbytes = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            nbytes += len(chunk)
    return h.hexdigest(), nbytes


def write_file_manifest(manifest_path: str, files: Dict[str, str]) -> str:
    """Write a manifest over existing files: ``files`` maps the
    manifest-relative name to the on-disk path. The manifest commits by
    tmp + fsync + replace."""
    manifest = {"version": 1, "files": {}}
    for name, path in files.items():
        sha, nbytes = _sha256_file(path)
        manifest["files"][name] = {"sha256": sha, "bytes": nbytes}
    tmp = manifest_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path)
    fsync_dir(os.path.dirname(manifest_path) or ".")
    return manifest_path


def verify_file_manifest(manifest_path: str, root: str) -> Optional[list]:
    """Check every file the manifest lists against its sha256 and size
    (names resolve under ``root``); the verified names, or None when
    there is no manifest. Raises ValueError naming a missing, truncated
    or corrupt file, or an unreadable manifest."""
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path, encoding="utf-8") as f:
            entries = json.load(f)["files"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ValueError(
            f"integrity manifest {manifest_path!r} is unreadable "
            f"({type(e).__name__}: {e}); re-save the model or delete the "
            "manifest to skip verification") from e
    verified = []
    for name, meta in entries.items():
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise ValueError(
                f"model file {path!r} is missing but listed in "
                f"{manifest_path!r}; the blob is incomplete — re-save it")
        sha, nbytes = _sha256_file(path)
        if nbytes != meta.get("bytes") or sha != meta.get("sha256"):
            raise ValueError(
                f"model file {path!r} is truncated or corrupt "
                f"(got {nbytes} bytes / sha256 {sha[:12]}..., manifest "
                f"says {meta.get('bytes')} bytes / "
                f"{str(meta.get('sha256'))[:12]}...) — re-save the model")
        verified.append(name)
    return verified

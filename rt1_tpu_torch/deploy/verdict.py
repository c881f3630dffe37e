"""Signed promotion-verdict artifacts: who approved this checkpoint.

The port's copy of `rt1_tpu/deploy/verdict.py` (the port imports nothing of
the JAX package); it keeps the JAX module's names and behaviour.
The signature bytes equal JAX's for the same key and payload.

A promotion decision outlives the process that made it — an incident
review three days later needs to know WHICH gate run (cells, episodes,
parity stats) approved the checkpoint now serving, and that the artifact
on disk is the one the controller wrote, not a hand-edited JSON. The
verdict is therefore signed: HMAC-SHA256 over the canonical JSON
encoding (sorted keys, fixed separators — byte-stable across Python
runs), keyed by a deployment secret.

Key resolution (``signing_key``): the ``RT1_DEPLOY_KEY`` env var when
set (fleet operators inject one key across controller + verifiers),
else a per-workdir key file generated once (`deploy_key`, mode 0600) —
so a single-host loop is signed out of the box without key management.

This is tamper-EVIDENCE, not secrecy: the payload stays readable JSON,
and anyone holding the key can re-sign. Stdlib only (hashlib/hmac/json)
— the controller process must stay import-light.
"""

from __future__ import annotations

import hmac
import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

ENV_KEY = "RT1_DEPLOY_KEY"
KEY_BASENAME = "deploy_key"
SIGNATURE_FIELD = "signature"


def canonical_bytes(payload: Dict[str, Any]) -> bytes:
    """Byte-stable encoding the signature covers (sorted keys, no
    whitespace variance). The signature field itself is excluded."""
    clean = {k: v for k, v in payload.items() if k != SIGNATURE_FIELD}
    return json.dumps(
        clean, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")


def signing_key(workdir: str) -> str:
    """Resolve the deployment signing key: env var, else a generated
    per-workdir key file (created once, 0600)."""
    env = os.environ.get(ENV_KEY)
    if env:
        return env
    path = os.path.join(workdir, KEY_BASENAME)
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    os.makedirs(workdir, exist_ok=True)
    key = os.urandom(32).hex()
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(key)
    os.replace(tmp, path)
    return key


def sign_payload(payload: Dict[str, Any], key: str) -> str:
    return hmac.new(
        key.encode("utf-8"), canonical_bytes(payload), hashlib.sha256
    ).hexdigest()


def write_verdict(
    path: str, payload: Dict[str, Any], key: str
) -> Dict[str, Any]:
    """Sign `payload` and write it atomically (tmp + rename, the repo's
    artifact convention). Returns the signed payload."""
    signed = {k: v for k, v in payload.items() if k != SIGNATURE_FIELD}
    signed[SIGNATURE_FIELD] = sign_payload(signed, key)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(signed, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return signed


def verify_verdict(
    path: str, key: str
) -> Tuple[Optional[Dict[str, Any]], bool]:
    """Read a verdict artifact -> (payload, signature_ok). A missing or
    torn file is (None, False) — absence is a verification failure, not
    an exception (the run-report renders what it can prove)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None, False
    if not isinstance(payload, dict):
        return None, False
    recorded = payload.get(SIGNATURE_FIELD)
    if not isinstance(recorded, str):
        return payload, False
    expected = sign_payload(payload, key)
    return payload, hmac.compare_digest(recorded, expected)

"""Credential store: encrypted in-memory cache with TTL refresh (port of
``karpenter_tpu/operator/credentials.py``).

Capability parity with ``pkg/cloudprovider/ibm/credentials.go``: secrets
are AES-GCM-encrypted at rest in process memory (:243-281) under an
ephemeral per-process key, refreshed on a TTL (:191), and sourced from
pluggable providers — env vars (:283), static/base64 (:355), or any
callable (the k8s-Secret provider analogue :309).
"""

from __future__ import annotations

import base64
import os
import threading
import time
from dataclasses import dataclass
from collections.abc import Callable, Mapping

from karpenter_tpu_torch.cloud.errors import CloudError
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("operator.credentials")

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:                          # pragma: no cover - env-gated
    AESGCM = None


class _FallbackAEAD:
    """In-memory scramble used only when ``cryptography`` is absent
    (dev/test containers; production images install it and get real
    AES-GCM).  HMAC-SHA256 counter-mode keystream + HMAC tag keeps the
    store's at-rest posture — no plaintext in attributes, tampering
    detected — under an ephemeral per-process key.  The key lives in the
    same process memory as the blob either way, so both ciphers are
    defense-in-depth against accidental dumps, not a confidentiality
    boundary."""

    def __init__(self, key: bytes):
        self._key = key

    @staticmethod
    def generate_key(bit_length: int = 256) -> bytes:
        return os.urandom(bit_length // 8)

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        import hashlib
        import hmac as _hmac

        out = b""
        counter = 0
        while len(out) < n:
            out += _hmac.new(self._key, nonce + counter.to_bytes(8, "big"),
                             hashlib.sha256).digest()
            counter += 1
        return out[:n]

    def _tag(self, nonce: bytes, ct: bytes) -> bytes:
        import hashlib
        import hmac as _hmac

        return _hmac.new(self._key, b"tag" + nonce + ct,
                         hashlib.sha256).digest()

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        ct = bytes(a ^ b for a, b in
                   zip(data, self._keystream(nonce, len(data))))
        return ct + self._tag(nonce, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        import hmac as _hmac

        ct, tag = data[:-32], data[-32:]
        if not _hmac.compare_digest(tag, self._tag(nonce, ct)):
            raise ValueError("credential blob authentication failed")
        return bytes(a ^ b for a, b in
                     zip(ct, self._keystream(nonce, len(ct))))


def _aead_factory():
    if AESGCM is not None:
        return AESGCM
    log.warning("cryptography not installed; credential store using "
                "stdlib HMAC-CTR fallback (install cryptography for "
                "AES-GCM)")
    return _FallbackAEAD


@dataclass(frozen=True)
class Credentials:
    api_key: str
    region: str
    iks_api_key: str = ""     # optional separate credential (ref VPC_API_KEY)

    def validate(self) -> None:
        if not self.api_key:
            raise CloudError("missing API key", 401, code="unauthorized",
                             retryable=False)
        if not self.region:
            raise CloudError("missing region", 400, code="bad_request",
                             retryable=False)


def resolve_api_key(env: Mapping[str, str]) -> str:
    """Single source of truth for the API-key env fallback chain — shared
    with Options.from_env so boot validation and options never diverge."""
    return env.get("TPU_CLOUD_API_KEY", env.get("IBMCLOUD_API_KEY", ""))


def resolve_region(env: Mapping[str, str]) -> str:
    return env.get("TPU_CLOUD_REGION", env.get("IBMCLOUD_REGION", ""))


class EnvCredentialProvider:
    """(ref credentials.go:283 env provider)"""

    def __init__(self, env: Mapping[str, str] | None = None):
        self.env = env

    def __call__(self) -> Credentials:
        env = os.environ if self.env is None else self.env
        return Credentials(
            api_key=resolve_api_key(env),
            region=resolve_region(env),
            iks_api_key=env.get("TPU_CLOUD_IKS_API_KEY", ""))


class StaticCredentialProvider:
    """Fixed credentials, optionally base64-wrapped (ref :355)."""

    def __init__(self, api_key: str, region: str, iks_api_key: str = "",
                 base64_encoded: bool = False):
        if base64_encoded:
            api_key = base64.b64decode(api_key).decode()
            iks_api_key = base64.b64decode(iks_api_key).decode() \
                if iks_api_key else ""
        self._creds = Credentials(api_key, region, iks_api_key)

    def __call__(self) -> Credentials:
        return self._creds


class CredentialStore:
    """TTL-cached credentials, AES-GCM-encrypted in memory.

    The plaintext only exists transiently inside :meth:`get`; between calls
    the store holds nonce+ciphertext under a per-process random key (the
    reference's in-memory encryption posture, credentials.go:243-281).
    """

    def __init__(self, provider: Callable[[], Credentials],
                 ttl: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        self._provider = provider
        self._ttl = ttl
        self._clock = clock
        aead = _aead_factory()
        self._key = aead.generate_key(bit_length=256)
        self._gcm = aead(self._key)
        self._lock = threading.Lock()
        self._blob: bytes | None = None       # nonce || ciphertext
        self._fetched_at = -float("inf")
        self._region = ""                        # non-secret, kept plain

    def get(self) -> Credentials:
        """Decrypt-and-return; refreshes from the provider past the TTL
        (double-checked under the lock, the pricing-refresh idiom)."""
        with self._lock:
            if self._blob is None or \
                    self._clock() - self._fetched_at >= self._ttl:
                try:
                    self._refresh_locked()
                except Exception:
                    # transient provider failure at TTL expiry: serve the
                    # still-valid cached credentials (the pricing-provider
                    # stale-on-error posture); only fail with no cache
                    if self._blob is None:
                        raise
                    log.warning("credential refresh failed; serving cached")
            return self._decrypt_locked()

    def invalidate(self) -> None:
        """Force the next get() to hit the provider (auth-failure path)."""
        with self._lock:
            self._fetched_at = -float("inf")

    # -- internals ---------------------------------------------------------

    def _refresh_locked(self) -> None:
        creds = self._provider()
        creds.validate()
        payload = "\x00".join((creds.api_key, creds.region,
                               creds.iks_api_key)).encode()
        nonce = os.urandom(12)
        self._blob = nonce + self._gcm.encrypt(nonce, payload, None)
        self._region = creds.region
        self._fetched_at = self._clock()
        log.info("credentials refreshed", region=creds.region)

    def _decrypt_locked(self) -> Credentials:
        nonce, ct = self._blob[:12], self._blob[12:]
        api_key, region, iks_api_key = \
            self._gcm.decrypt(nonce, ct, None).decode().split("\x00")
        return Credentials(api_key, region, iks_api_key)

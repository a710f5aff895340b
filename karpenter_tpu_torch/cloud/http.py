"""HTTP client layer for real cloud backends
(port of ``karpenter_tpu/cloud/http.py``).

Parity with ``pkg/httpclient`` (typed IBMCloudError parsing,
client.go:55-224) and the IAM token handling of
``pkg/cloudprovider/ibm/iam.go``: a minimal, dependency-free REST helper
(urllib) with

- bearer-token auth + refresh-before-expiry,
- typed :class:`~karpenter_tpu_torch.cloud.errors.CloudError` parsing from
  JSON error envelopes,
- 429 Retry-After honoring + exponential backoff for retryable statuses
  (the ratelimit_retry.go:39 contract, via cloud/retry.py),
- request metrics per (service, operation, status).

The fake cloud remains the default in tests/sim; this layer is the seam
a production backend plugs into (the FakeCloud and an HTTP-backed client
expose the same provider-facing surface).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections.abc import Callable

from karpenter_tpu_torch.cloud.errors import CloudError, parse_error
from karpenter_tpu_torch.cloud.retry import retry_with_backoff
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.http")


class TokenSource:
    """IAM-style bearer token with refresh-before-expiry
    (ref iam.go:76: fetch, cache, refresh when <5m left)."""

    REFRESH_MARGIN = 300.0

    def __init__(self, fetch: Callable[[], dict],
                 clock: Callable[[], float] = time.monotonic):
        """``fetch() -> {"access_token": str, "expires_in": seconds}``"""
        self._fetch = fetch
        self._clock = clock
        self._lock = threading.Lock()
        self._token = ""
        self._expires_at = -float("inf")

    def token(self) -> str:
        with self._lock:
            if self._clock() >= self._expires_at - self.REFRESH_MARGIN:
                data = self._fetch()
                self._token = data["access_token"]
                self._expires_at = self._clock() + float(
                    data.get("expires_in", 3600))
            return self._token

    def invalidate(self) -> None:
        with self._lock:
            self._expires_at = -float("inf")


class HTTPClient:
    """Thin JSON REST client with typed errors and retry."""

    def __init__(self, base_url: str, service: str,
                 token_source: TokenSource | None = None,
                 timeout: float = 30.0,
                 opener: Callable | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 budget: float | None = None):
        self.base_url = base_url.rstrip("/")
        self.service = service
        self.tokens = token_source
        self.timeout = timeout
        # overall wall-clock budget per request (retries + Retry-After
        # sleeps included; cloud/retry.py deadline propagation) — a
        # controller-owned client caps every call below its requeue
        # interval so the retry loop can never outlive the reconcile
        self.budget = budget
        # injectable transport/sleep for tests
        self._open = opener or urllib.request.urlopen
        self._sleep = sleep

    # -- verbs -------------------------------------------------------------

    def get(self, path: str, operation: str = "get",
            budget: float | None = None) -> dict:
        return self.request("GET", path, operation=operation, budget=budget)

    def post(self, path: str, body: dict, operation: str = "post",
             budget: float | None = None) -> dict:
        return self.request("POST", path, body=body, operation=operation,
                            budget=budget)

    def delete(self, path: str, operation: str = "delete",
               budget: float | None = None) -> dict:
        return self.request("DELETE", path, operation=operation,
                            budget=budget)

    def request(self, method: str, path: str, body: dict | None = None,
                operation: str = "request",
                budget: float | None = None) -> dict:
        def attempt():
            return self._do(method, path, body, operation)

        return retry_with_backoff(
            attempt, operation=operation, sleep=self._sleep,
            budget=budget if budget is not None else self.budget)

    # -- internals ---------------------------------------------------------

    def _do(self, method: str, path: str, body: dict | None,
            operation: str) -> dict:
        url = f"{self.base_url}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.tokens is not None:
            req.add_header("Authorization", f"Bearer {self.tokens.token()}")
        # one span per wire attempt — retries are SEPARATE spans, so a
        # dumped trace shows each round trip with its own status
        with obs.span(f"rpc.{self.service}.{operation}", method=method,
                      path=path) as sp:
            try:
                with self._open(req, timeout=self.timeout) as resp:
                    status = getattr(resp, "status", 200)
                    sp.set("status", status)
                    metrics.API_REQUESTS.labels(self.service, operation,
                                                str(status)).inc()
                    payload = resp.read()
                    return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                sp.set("status", e.code)
                metrics.API_REQUESTS.labels(self.service, operation,
                                            str(e.code)).inc()
                if e.code in (401, 403) and self.tokens is not None:
                    self.tokens.invalidate()  # force re-auth on next attempt
                raise self._typed_error(e, operation)
            except urllib.error.URLError as e:
                sp.set("status", "network")
                metrics.API_REQUESTS.labels(self.service, operation,
                                            "network").inc()
                raise CloudError(f"{operation}: {e.reason}", status_code=0,
                                 code="network", retryable=True)

    @staticmethod
    def _typed_error(e: "urllib.error.HTTPError", operation: str) -> CloudError:
        """Parse the JSON error envelope into the shared taxonomy
        (ref httpclient/client.go:55-224 IBMCloudError parsing)."""
        retry_after = 0.0
        try:
            retry_after = float(e.headers.get("Retry-After", 0))
        except (TypeError, ValueError):
            pass
        message, code = str(e.reason), ""
        try:
            envelope = json.loads(e.read())
            errs = envelope.get("errors") or []
            if errs:
                message = errs[0].get("message", message)
                code = errs[0].get("code", "")
            else:
                message = envelope.get("message", message)
                code = envelope.get("code", "")
        except Exception as parse_exc:
            # a malformed error envelope still yields a typed CloudError
            # from the HTTP status; record why the body was unusable
            log.debug("unparseable error envelope", operation=operation,
                      status=e.code, error=str(parse_exc))
        err = parse_error(
            CloudError(f"{operation}: {message}", status_code=e.code,
                       code=code),
            operation=operation)
        if retry_after > 0:
            err.retry_after = retry_after
        return err

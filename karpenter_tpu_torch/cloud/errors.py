"""Cloud error taxonomy.

Parity with ``pkg/cloudprovider/ibm/errors.go``: a typed error carrying
status code / error code / retryability (errors.go:54), parseable from
loose sources (:134-296), with the predicate set the rest of the system
branches on (:298-331).

(Copy of ``karpenter_tpu/cloud/errors.py``.)
"""

from __future__ import annotations


# Error codes (the cloud-API-level taxonomy).
CODE_NOT_FOUND = "not_found"
CODE_RATE_LIMIT = "rate_limited"
CODE_TIMEOUT = "timeout"
CODE_QUOTA_EXCEEDED = "quota_exceeded"
CODE_CAPACITY = "insufficient_capacity"
CODE_AUTH = "unauthorized"
CODE_CONFLICT = "conflict"
CODE_INVALID = "invalid_request"
CODE_INTERNAL = "internal_error"
CODE_UNAVAILABLE = "service_unavailable"

_RETRYABLE_CODES = {CODE_RATE_LIMIT, CODE_TIMEOUT, CODE_INTERNAL, CODE_UNAVAILABLE}
_RETRYABLE_STATUS = {408, 429, 500, 502, 503, 504}


class CloudError(Exception):
    """Typed cloud API error (ref IBMError, errors.go:54)."""

    def __init__(self, message: str, status_code: int = 0, code: str = "",
                 retryable: bool | None = None, retry_after: float = 0.0,
                 operation: str = ""):
        super().__init__(message)
        self.message = message
        self.status_code = status_code
        self.code = code or _code_from_status(status_code)
        self.retry_after = retry_after
        self.operation = operation
        if retryable is None:
            retryable = (self.code in _RETRYABLE_CODES
                         or status_code in _RETRYABLE_STATUS)
        self.retryable = retryable

    def __repr__(self):
        return (f"CloudError(code={self.code!r}, status={self.status_code}, "
                f"retryable={self.retryable}, msg={self.message!r})")


def _code_from_status(status: int) -> str:
    return {
        404: CODE_NOT_FOUND, 429: CODE_RATE_LIMIT, 408: CODE_TIMEOUT,
        401: CODE_AUTH, 403: CODE_AUTH, 409: CODE_CONFLICT,
        400: CODE_INVALID, 500: CODE_INTERNAL, 502: CODE_UNAVAILABLE,
        503: CODE_UNAVAILABLE, 504: CODE_TIMEOUT,
    }.get(status, "")


def not_found(resource: str, ident: str) -> CloudError:
    return CloudError(f"{resource} {ident!r} not found", status_code=404)


def parse_error(err: Exception, operation: str = "") -> CloudError:
    """Normalize any exception into a CloudError (ref ParseError,
    errors.go:134-296): typed errors pass through; strings are classified
    by substring heuristics."""
    if isinstance(err, CloudError):
        return err
    msg = str(err)
    lower = msg.lower()
    if "not found" in lower or "no such" in lower:
        return CloudError(msg, 404, operation=operation)
    if "rate limit" in lower or "too many requests" in lower:
        return CloudError(msg, 429, operation=operation)
    if "timeout" in lower or "timed out" in lower or "deadline" in lower:
        return CloudError(msg, 408, operation=operation)
    if "quota" in lower:
        return CloudError(msg, 403, code=CODE_QUOTA_EXCEEDED,
                          retryable=False, operation=operation)
    if "capacity" in lower or "out of stock" in lower:
        return CloudError(msg, 503, code=CODE_CAPACITY, retryable=False,
                          operation=operation)
    if "unauthorized" in lower or "forbidden" in lower or "invalid token" in lower:
        return CloudError(msg, 401, operation=operation)
    return CloudError(msg, 500, operation=operation)


# Predicates (errors.go:298-331).

def is_not_found(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code == CODE_NOT_FOUND


def is_rate_limit(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code == CODE_RATE_LIMIT


def is_timeout(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code == CODE_TIMEOUT


def is_retryable(err: Exception) -> bool:
    if isinstance(err, CloudError):
        return err.retryable
    return parse_error(err).retryable


def is_capacity(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code == CODE_CAPACITY


def is_quota(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code == CODE_QUOTA_EXCEEDED


def is_auth(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.status_code in (401, 403)


class NodeClaimNotFoundError(Exception):
    """Signals the core lifecycle to release the finalizer — the instance is
    verifiably gone (ref contract at vpc/instance/provider.go:1041-1046)."""

    def __init__(self, claim_name: str):
        super().__init__(f"nodeclaim {claim_name!r}: instance not found")
        self.claim_name = claim_name

"""The serving failure taxonomy (counterpart of the JAX ``infer/errors.py``,
class for class): every failure the engines raise at their edge is one
``ServingError`` subclass, so the server maps it to a status code and a
structured JSON body instead of a bare 500. Two axes matter to a client:

- **retryable**: the request itself is not at fault (queue overflow, a
  brownout shed, a queue deadline, a drain, a restart); the same request
  later, or on another replica, is expected to succeed. Served as 429 or
  503, with a ``Retry-After`` hint where the engine can derive one from its
  observed service time;
- **fatal**: retrying is pointless (the engine died, its circuit is open,
  the client's own deadline is spent). Each class carries its status.

``is_retryable_failure`` classifies a raw worker exception: anything not on
the explicit fatal list is presumed transient. The port has no supervisor
yet, so its engines treat every worker failure as terminal
(``FatalEngineError``); the classification is kept for the day they
restart.

The adapter, tenant and fleet classes come along because they are plain
classes of the same taxonomy; nothing in the port raises them until those
modules are ported.
"""

from __future__ import annotations

from typing import Optional, Tuple


class ServingError(RuntimeError):
    """Base class for every error the serving stack raises at its edge.
    Class attributes give each subclass its identity; instances add the
    message and the optional retry and generation hints."""

    kind = "serving_error"
    status = 500
    retryable = False

    def __init__(self, message: str, retry_after_s: Optional[float] = None,
                 generation: Optional[int] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.generation = generation

    def to_dict(self) -> dict:
        """The JSON body the server returns (and a stream's error event)."""
        d = {"kind": self.kind, "message": str(self), "retryable": self.retryable}
        if self.retry_after_s is not None:
            d["retry_after_s"] = round(float(self.retry_after_s), 3)
        if self.generation is not None:
            d["generation"] = int(self.generation)
        return d


class RetryableEngineError(ServingError):
    """The worker failed mid-flight and is restarting; this request failed
    fast, and the next attempt should reach a healthy generation."""

    kind = "engine_restarting"
    status = 503
    retryable = True


class FatalEngineError(ServingError):
    """The worker died for good; the process needs an external restart
    (``/healthz`` answers 503)."""

    kind = "engine_fatal"
    status = 500
    retryable = False


class CircuitOpenError(ServingError):
    """Too many worker failures inside the window: restarts stopped, and
    requests fail fast until the process is recycled."""

    kind = "circuit_open"
    status = 503
    retryable = False


class QueueOverflowError(ServingError):
    """The bounded admission queue is full: shed at submit with 429 and a
    Retry-After from the observed service time. Carries the shed request's
    priority tier, so a client can tell a best-effort displacement from
    total saturation."""

    kind = "queue_overflow"
    status = 429
    retryable = True

    def __init__(self, message: str, retry_after_s: Optional[float] = None,
                 generation: Optional[int] = None, tier: Optional[str] = None):
        super().__init__(message, retry_after_s, generation)
        self.tier = tier

    def to_dict(self) -> dict:
        d = super().to_dict()
        if self.tier is not None:
            d["tier"] = self.tier
        return d


class BrownoutShedError(QueueOverflowError):
    """Brownout stage 3: ``best_effort`` traffic is shed before it enqueues.
    A QueueOverflowError, so anything that handles a full replica handles a
    browned-out one the same way."""

    kind = "brownout_shed"
    status = 429
    retryable = True


class QueueDeadlineError(ServingError):
    """The request waited in the queue past the engine's queue deadline;
    shed before prefill."""

    kind = "queue_deadline"
    status = 503
    retryable = True


class DeadlineExceededError(ServingError):
    """The client's own deadline (``deadline_ms``) expired: in the queue, at
    prefill or mid-decode. Not retryable as it is (the budget is spent); the
    body carries the tokens generated before the cancel."""

    kind = "deadline_exceeded"
    status = 504
    retryable = False

    def __init__(self, message: str, tokens: Optional[Tuple[int, ...]] = None,
                 retry_after_s: Optional[float] = None, generation: Optional[int] = None):
        super().__init__(message, retry_after_s, generation)
        self.tokens = list(tokens) if tokens else []

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["tokens_generated"] = len(self.tokens)
        d["partial_tokens"] = [int(t) for t in self.tokens]
        return d


class DrainingError(ServingError):
    """The server is draining: admission is closed, in-flight work
    finishes. Retry against another replica."""

    kind = "draining"
    status = 503
    retryable = True


class UnknownAdapterError(ServingError):
    """The request named an adapter the registry cannot resolve; the body
    lists the adapters that are servable."""

    kind = "unknown_adapter"
    status = 404
    retryable = False

    def __init__(self, message: str, known: Optional[Tuple[str, ...]] = None,
                 retry_after_s: Optional[float] = None, generation: Optional[int] = None):
        super().__init__(message, retry_after_s, generation)
        self.known = tuple(known) if known else ()

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["known_adapters"] = list(self.known)
        return d


class AdapterPoolFullError(ServingError):
    """Every adapter pool slot is pinned by live requests."""

    kind = "adapter_pool_full"
    status = 429
    retryable = True


class TenantQuotaError(ServingError):
    """The tenant already has its quota of requests in flight."""

    kind = "tenant_quota"
    status = 429
    retryable = True


class NoHealthyReplicaError(ServingError):
    """Every replica of a fleet is terminally dead."""

    kind = "no_healthy_replica"
    status = 503
    retryable = False


class InjectedFault(RuntimeError):
    """A deliberate fault raised inside an engine worker by a test. Not a
    ServingError: it stands for a raw device failure and takes the
    classification path."""


# exceptions that end a worker for good: retrying cannot help
_FATAL_TYPES = (MemoryError, NotImplementedError, AssertionError, KeyboardInterrupt, SystemExit)


def is_retryable_failure(exc: BaseException) -> bool:
    """Classify a raw engine-worker exception."""
    if isinstance(exc, ServingError):
        return exc.retryable
    return not isinstance(exc, _FATAL_TYPES)


def error_payload(exc: BaseException) -> Tuple[int, dict, Optional[float]]:
    """(http status, JSON body, retry_after_s) for any exception that reaches
    the server's edge. Taxonomy classes carry their own status; a raw
    TimeoutError is a 503, anything else a 500."""
    if isinstance(exc, ServingError):
        return exc.status, {"error": exc.to_dict()}, exc.retry_after_s
    if isinstance(exc, TimeoutError):
        return 503, {"error": {"kind": "timeout", "message": str(exc), "retryable": True}}, None
    return 500, {"error": {"kind": "internal", "message": f"{type(exc).__name__}: {exc}",
                           "retryable": False}}, None

"""The port's serving failure taxonomy (``infer/errors.py``) against the JAX
package's, class by class: the same status, kind, retryability and
``to_dict`` body for the same arguments, and the same ``error_payload`` and
``is_retryable_failure`` for taxonomy and raw exceptions (mirrors
``tests/test_supervisor.py::test_error_taxonomy_statuses_and_payloads``)."""

import inspect

import pytest

from llm_fine_tune_distributed_tpu.infer import errors as jax_errors
from llm_fine_tune_distributed_tpu_torch.infer import errors

CLASSES = sorted(
    name for name, obj in vars(jax_errors).items()
    if inspect.isclass(obj) and issubclass(obj, jax_errors.ServingError)
)


def _args(name):
    """One message and every optional hint the class takes."""
    kw = {"retry_after_s": 2.71828, "generation": 3}
    if name in ("QueueOverflowError", "BrownoutShedError"):
        kw["tier"] = "best_effort"
    if name == "DeadlineExceededError":
        kw["tokens"] = (5, 7, 11)
    if name == "UnknownAdapterError":
        kw["known"] = ("a", "b")
    return f"{name} happened", kw


def test_every_jax_class_is_ported():
    ported = sorted(name for name, obj in vars(errors).items()
                    if inspect.isclass(obj) and issubclass(obj, errors.ServingError))
    assert ported == CLASSES and len(CLASSES) == 13
    assert issubclass(errors.InjectedFault, RuntimeError)
    assert not issubclass(errors.InjectedFault, errors.ServingError)


@pytest.mark.parametrize("name", CLASSES)
def test_status_kind_and_body_equal_the_jax_class(name):
    msg, kw = _args(name)
    port_cls, jax_cls = getattr(errors, name), getattr(jax_errors, name)
    assert (port_cls.status, port_cls.kind, port_cls.retryable) == (
        jax_cls.status, jax_cls.kind, jax_cls.retryable)
    assert [c.__name__ for c in port_cls.__mro__[:-3]] == [
        c.__name__ for c in jax_cls.__mro__[:-3]]
    assert port_cls(msg, **kw).to_dict() == jax_cls(msg, **kw).to_dict()
    assert port_cls(msg).to_dict() == jax_cls(msg).to_dict()
    port_e, jax_e = port_cls(msg, **kw), jax_cls(msg, **kw)
    assert errors.error_payload(port_e) == jax_errors.error_payload(jax_e)
    assert errors.is_retryable_failure(port_e) == jax_errors.is_retryable_failure(jax_e)


@pytest.mark.parametrize("exc", [
    TimeoutError("waited 3s"), RuntimeError("transient"), ValueError("bad"),
    MemoryError("oom"), NotImplementedError("no kernel"), AssertionError("x"),
    KeyboardInterrupt(), ZeroDivisionError("0"),
], ids=lambda e: type(e).__name__)
def test_raw_exceptions_map_as_in_jax(exc):
    assert errors.error_payload(exc) == jax_errors.error_payload(exc)
    assert errors.is_retryable_failure(exc) == jax_errors.is_retryable_failure(exc)
    injected = errors.InjectedFault("boom")
    assert errors.is_retryable_failure(injected) and errors.error_payload(injected)[0] == 500


def test_error_taxonomy_statuses_and_payloads():
    """The JAX supervisor test's assertions, on the port's classes."""
    assert errors.error_payload(errors.QueueOverflowError("full", retry_after_s=3.0))[0] == 429
    assert errors.error_payload(errors.RetryableEngineError("x"))[0] == 503
    assert errors.error_payload(errors.CircuitOpenError("x"))[0] == 503
    assert errors.error_payload(errors.DrainingError("x"))[0] == 503
    status, payload, retry = errors.error_payload(
        errors.QueueOverflowError("full", retry_after_s=3.0))
    assert payload["error"]["kind"] == "queue_overflow"
    assert payload["error"]["retryable"] is True
    assert retry == 3.0
    assert errors.is_retryable_failure(RuntimeError("transient"))
    assert not errors.is_retryable_failure(MemoryError("oom"))
    assert not errors.is_retryable_failure(NotImplementedError("no kernel"))

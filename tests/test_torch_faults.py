"""The port's failure taxonomy and fault-injection plan
(``rnb_tpu_torch.faults``) and fault ledger (``rnb_tpu_torch.control``)
held to the JAX package's.

The same exceptions, plan specs and ledger calls go through both
packages: ``classify_error`` and ``fault_reason`` over a table of
exceptions (``OSError`` subclasses among them), ``validate_plan``'s
message for each malformed spec, the seeded plan's decisions
(``FaultPlan.fire`` and ``stall_ms``) for request ids 0-999 at steps 0
and 1 and attempts 0-2 under three seeds and three specs, the env
precedence of ``FaultPlan.resolve``, ``check_steps`` and ``describe``,
and the snapshots of ``FaultStats`` and ``dispose_requests`` — all
equal. The port's decode errors classify as permanent and transient and
stay ``ValueError``s.
"""

import itertools
import json

import pytest

from rnb_tpu import control as jax_control
from rnb_tpu import faults as jax_faults
from rnb_tpu_torch import control, decode, faults
from rnb_tpu_torch.decode import native


def _both(name, *args):
    """One exception class of the taxonomy built in each package."""
    return getattr(faults, name)(*args), getattr(jax_faults, name)(*args)


TAXONOMY = ["TransientError", "PermanentError", "CorruptVideoError",
            "TransientDecodeError", "InjectedTransientError",
            "InjectedPermanentError", "NetRefusedError", "NetResetError",
            "NetTimeoutError", "NetPartialFrameError",
            "NetCorruptFrameError"]
#: exceptions both packages share (builtins), OSError subclasses first
BUILTINS = [OSError("io blip"), FileNotFoundError("gone"),
            IsADirectoryError("dir"), NotADirectoryError("nodir"),
            PermissionError("denied"), ConnectionResetError("reset"),
            BrokenPipeError("pipe"), TimeoutError("slow"),
            InterruptedError("eintr"), BlockingIOError("again"),
            ValueError("bug"), KeyError("k"), AssertionError(),
            RuntimeError("boom"), MemoryError(), ZeroDivisionError()]


@pytest.mark.parametrize("name", TAXONOMY)
def test_taxonomy_classifies_as_the_reference(name):
    port, ref = _both(name, "x")
    assert faults.classify_error(port) == jax_faults.classify_error(ref)
    assert faults.fault_reason(port) == jax_faults.fault_reason(ref)
    # a plan's custom reason overrides the class's
    port.fault_reason, ref.fault_reason = "custom", "custom"
    assert faults.fault_reason(port) == jax_faults.fault_reason(ref) \
        == "custom"


@pytest.mark.parametrize("exc", BUILTINS, ids=lambda e: type(e).__name__)
def test_builtin_errors_classify_as_the_reference(exc):
    assert faults.classify_error(exc) == jax_faults.classify_error(exc)
    assert faults.fault_reason(exc) == jax_faults.fault_reason(exc)


@pytest.mark.parametrize("fate", ["crash", "stall"])
def test_lane_death_is_fatal_with_the_reference_reason(fate):
    port = faults.LaneDeathError("lane 3", fate)
    ref = jax_faults.LaneDeathError("lane 3", fate)
    assert faults.classify_error(port) == jax_faults.classify_error(ref) \
        == faults.FATAL
    assert faults.fault_reason(port) == jax_faults.fault_reason(ref)


def test_the_decode_errors_are_classified_value_errors():
    assert decode.CorruptVideoError is faults.CorruptVideoError
    assert decode.TransientDecodeError is faults.TransientDecodeError
    assert native.CorruptVideoError is faults.CorruptVideoError
    corrupt = decode.CorruptVideoError("bad header")
    blip = decode.TransientDecodeError("rc -1")
    assert isinstance(corrupt, ValueError) and isinstance(blip, ValueError)
    assert faults.classify_error(corrupt) == faults.PERMANENT
    assert faults.classify_error(blip) == faults.TRANSIENT
    assert faults.fault_reason(corrupt) == "corrupt-video"
    assert faults.fault_reason(blip) == "decode-io"
    # the native decoder's codes: -1 transient, -2/-3/-5 permanent
    with pytest.raises(faults.TransientDecodeError):
        native._check(-1, "v.y4m")
    for rc in (-2, -3, -5):
        with pytest.raises(faults.CorruptVideoError):
            native._check(rc, "v.y4m")
    with pytest.raises(ValueError) as error:
        native._check(-4, "v.y4m")
    assert faults.classify_error(error.value) == faults.FATAL


BAD_PLANS = [
    [], "plan", {"seed": "1", "faults": []},
    {"seed": 1}, {"faults": {}},
    {"faults": ["x"]},
    {"faults": [{"kind": "boom", "request_ids": [1]}]},
    {"faults": [{"kind": "transient", "step": -1, "request_ids": [1]}]},
    {"faults": [{"kind": "transient", "step": 1.5, "request_ids": [1]}]},
    {"faults": [{"kind": "transient"}]},
    {"faults": [{"kind": "transient", "request_ids": [1],
                 "probability": 0.5}]},
    {"faults": [{"kind": "transient", "request_ids": ["1"]}]},
    {"faults": [{"kind": "transient", "request_ids": 3}]},
    {"faults": [{"kind": "transient", "probability": 1.5}]},
    {"faults": [{"kind": "transient", "probability": "half"}]},
    {"faults": [{"kind": "transient", "request_ids": [1], "fatal": True}]},
    {"faults": [{"kind": "net_reset", "request_ids": [1], "fatal": 1}]},
    {"faults": [{"kind": "net_reset", "step": 0, "request_ids": [1]}]},
    {"faults": [{"kind": "net_reset", "lane": 0, "request_ids": [1]}]},
    {"faults": [{"kind": "net_reset", "times": 2, "request_ids": [1]}]},
    {"faults": [{"kind": "net_timeout", "request_ids": [1]}]},
    {"faults": [{"kind": "net_refused", "ms": 5, "request_ids": [1]}]},
    {"faults": [{"kind": "latency", "request_ids": [1]}]},
    {"faults": [{"kind": "stall", "ms": -1, "request_ids": [1]}]},
    {"faults": [{"kind": "stall", "ms": 5, "times": 2,
                 "request_ids": [1]}]},
    {"faults": [{"kind": "replica_crash", "ms": 5, "request_ids": [1]}]},
    {"faults": [{"kind": "replica_crash", "times": 1,
                 "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "ms": 5, "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "times": 0, "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "lane": -1, "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "lane": True, "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "reason": 7, "request_ids": [1]}]},
    {"faults": [{"kind": "permanent", "request_ids": [1], "when": 0}]},
    {"faults": [], "extra": 1},
]


@pytest.mark.parametrize("spec", BAD_PLANS, ids=range(len(BAD_PLANS)))
def test_validate_plan_gives_the_reference_message(spec):
    with pytest.raises(ValueError) as ref:
        jax_faults.validate_plan(json.loads(json.dumps(spec)))
    with pytest.raises(ValueError) as port:
        faults.validate_plan(spec)
    assert str(port.value) == str(ref.value)


#: three specs: id lists with times, probabilities on every step, and
#: every delay kind (0 ms, so the walk does not sleep)
SPECS = [
    {"faults": [
        {"step": 0, "kind": "permanent", "request_ids": [3, 17, 400]},
        {"step": 1, "kind": "transient", "request_ids": [5, 17, 999],
         "times": 2},
        {"step": 0, "kind": "stall", "ms": 40, "request_ids": [8]}]},
    {"faults": [
        {"kind": "transient", "probability": 0.1},
        {"step": 1, "kind": "permanent", "probability": 0.05,
         "reason": "chaos-perm"},
        {"kind": "stall", "ms": 3, "probability": 0.2}]},
    {"faults": [
        {"step": 1, "kind": "latency", "ms": 0, "probability": 0.3},
        {"step": 0, "kind": "transient", "probability": 0.5, "times": 3},
        {"kind": "stall", "ms": 7.5, "request_ids": [1, 2, 3]},
        {"step": 0, "kind": "stall", "ms": 2, "probability": 0.4}]},
]


def _decision(plan, step, rids, attempt):
    """What one attempt meets: None, or the error's class, message and
    reason (by its own package's ``fault_reason``)."""
    module = faults if isinstance(plan, faults.FaultPlan) else jax_faults
    try:
        plan.fire(step, rids, attempt)
    except Exception as e:
        return (type(e).__name__, str(e), module.fault_reason(e))
    return None


@pytest.mark.parametrize("seed,spec_idx",
                         list(itertools.product([0, 7, 12345], range(3))))
def test_the_seeded_plan_decides_as_the_reference(seed, spec_idx):
    spec = dict(SPECS[spec_idx], seed=seed)
    port = faults.FaultPlan(json.loads(json.dumps(spec)))
    ref = jax_faults.FaultPlan(json.loads(json.dumps(spec)))
    fired = 0
    for rid, step in itertools.product(range(1000), (0, 1)):
        assert port.stall_ms(step, rid) == ref.stall_ms(step, rid)
        for attempt in range(3):
            got = _decision(port, step, rid, attempt)
            assert got == _decision(ref, step, rid, attempt), \
                (rid, step, attempt)
            fired += got is not None
    assert fired > 0
    # a fused dispatch: any constituent's fault hits it
    for rids in ([0, 3, 5], [16, 17], [998, 999], list(range(40))):
        for step, attempt in itertools.product((0, 1), range(3)):
            assert _decision(port, step, rids, attempt) == \
                _decision(ref, step, rids, attempt)
        assert port.stall_ms(0, rids) == ref.stall_ms(0, rids)
    assert port.describe() == ref.describe()


def test_resolve_check_steps_and_the_env_plan(monkeypatch):
    config_plan = {"faults": [{"step": 2, "kind": "transient",
                               "request_ids": [1]}]}
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    assert faults.FaultPlan.resolve(None) is None
    port = faults.FaultPlan.resolve(config_plan)
    ref = jax_faults.FaultPlan.resolve(config_plan)
    assert port.describe() == ref.describe()
    with pytest.raises(ValueError) as ref_error:
        ref.check_steps(2)
    with pytest.raises(ValueError) as port_error:
        port.check_steps(2)
    assert str(port_error.value) == str(ref_error.value)
    port.check_steps(3)
    # the env plan wins over the config's
    monkeypatch.setenv(faults.ENV_PLAN, json.dumps(
        {"seed": 4, "faults": [{"kind": "stall", "ms": 1,
                                "probability": 1.0}]}))
    assert faults.FaultPlan.resolve(config_plan).describe() == \
        jax_faults.FaultPlan.resolve(config_plan).describe() == \
        "seed=4, 1 fault(s) [1 stall]"
    monkeypatch.setenv(faults.ENV_PLAN, "{not json")
    with pytest.raises(ValueError) as ref_error:
        jax_faults.FaultPlan.from_env()
    with pytest.raises(ValueError) as port_error:
        faults.FaultPlan.from_env()
    assert str(port_error.value) == str(ref_error.value)
    assert faults.ENV_PLAN == jax_faults.ENV_PLAN


def test_net_and_lane_kinds_validate_and_are_named():
    spec = {"faults": [
        {"kind": "net_reset", "request_ids": [1], "fatal": True},
        {"kind": "net_timeout", "ms": 5, "probability": 0.5},
        {"step": 1, "kind": "replica_stall", "ms": 5, "lane": 2,
         "request_ids": [4]}]}
    port, ref = faults.FaultPlan(spec), jax_faults.FaultPlan(spec)
    assert port.has_net_faults() and ref.has_net_faults()
    assert faults.NET_KINDS == jax_faults.NET_KINDS
    assert faults.LANE_KINDS == jax_faults.LANE_KINDS
    assert faults.VALID_KINDS == jax_faults.VALID_KINDS
    for rid in range(50):
        assert port.net_fault("net_timeout", rid) == \
            ref.net_fault("net_timeout", rid)
    assert port.describe() == ref.describe()


def _ledger_script(module):
    stats = module.FaultStats()
    stats.record_failure([3], 0, "injected-permanent")
    stats.record_failure([7, 8, 9], 1, "retries-exhausted:decode-io")
    stats.record_shed("filename_queue")
    stats.record_shed("step1_take:deadline_expired", 4)
    stats.record_shed("step0_out_queue", 2)
    stats.record_retries()
    stats.record_retries(3)
    stats.record_overflow("step0->step1")
    stats.record_overflow("filename_queue", 2)
    for rid in range(stats.MAX_DEAD_LETTERS + 5):
        stats.record_failure([100 + rid], 0, "corrupt-video")
    counter = module.InferenceCounter()
    termination = module.TerminationState()
    steps = [module.dispose_requests(counter, 6, termination, n)
             for n in (2, 3, 1, 4)]
    return (stats.snapshot(), steps, counter.value,
            int(termination.value))


def test_fault_stats_and_dispose_requests_equal_the_reference():
    got, want = _ledger_script(control), _ledger_script(jax_control)
    assert got == want
    snapshot, _, value, flag = got
    assert len(snapshot["dead_letters"]) == control.FaultStats.\
        MAX_DEAD_LETTERS
    assert snapshot["num_failed"] == 4 + control.FaultStats.\
        MAX_DEAD_LETTERS + 5
    assert value == 10 and flag == int(
        control.TerminationFlag.TARGET_NUM_VIDEOS_REACHED)

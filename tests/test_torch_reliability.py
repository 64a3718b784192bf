"""The port's fault-tolerant serving, re-pointed from
``tests/test_reliability.py`` (every test but the two mesh-fallback ones,
which need the mesh), and held against the JAX package's reliability layer.

* a mid-pump failure is isolated to the failing *group*; its futures fail
  with typed ``RequestError``s while every other group serves normally;
* recovery is crash-consistent — each failed attempt rolls the executor's
  residency back, every retry re-predicts from it, and only successful
  attempts merge into the counters, so ``session.stats ==
  session.predicted`` stays exact through rollbacks, retries and the
  unfused rung;
* under random fault schedules, deadlines, priorities and admission orders,
  every future reaches a terminal state and every successful response
  matches a fault-free sequential serve.

Against the reference: ``FaultInjector`` (the same numpy generator) and
``RetryPolicy`` give identical schedules and backoffs, and the same seeded
chaos scenario gives the same admission rounds, group attempts, per-response
``retries`` and ``degraded``, failures and ``session.stats``.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.core.types import MSP430 as R_MSP430
from repro.serving import engine as r_engine
from repro.serving import policies as r_pol
from repro.serving import reliability as r_rel
from repro.serving.batching import RequestGroupScheduler as RScheduler
from repro_torch.core import MSP430
from repro_torch.serving import (
    DeadlineExceeded, FaultInjector, InjectedFault, MultitaskEngine,
    MultitaskRequest, QueueFull, RequestError, RequestGroupScheduler,
    RetryPolicy, SloAwarePolicy, TenantStats, WindowPolicy,
)
from repro_torch.serving import engine as p_engine
from repro_torch.serving import policies as p_pol
from repro_torch.serving import reliability as p_rel
from tests.test_session import PROGRAM as R_PROGRAM
from tests.test_torch_session import (
    DIM, PROGRAM, SUBSET_CHOICES, FakeClock, Recorder, _requests, _x,
)



def _engine(**kwargs):
    kwargs.setdefault("scheduler", RequestGroupScheduler(batch_shapes=(1, 4)))
    return MultitaskEngine(PROGRAM, hw=MSP430, **kwargs)


def _reference_outputs(requests):
    """Fault-free sequential serve, SLO metadata stripped: the ground truth
    for every scenario."""
    eng = _engine()
    return [eng.serve(MultitaskRequest(x=r.x, tasks=r.tasks)) for r in requests]


def _assert_allclose_response(got, ref):
    assert set(got.outputs) == set(ref.outputs)
    for t in ref.outputs:
        np.testing.assert_allclose(
            got.outputs[t].numpy(), ref.outputs[t].numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Unit coverage: injector, retry policy, tenant stats
# --------------------------------------------------------------------------

def test_fault_injector_script_and_determinism():
    inj = FaultInjector(script={"plan": {1}}, rates={"dispatch": 0.5}, seed=7)
    inj.check("plan")  # invocation 0: not scripted
    with pytest.raises(InjectedFault) as exc:
        inj.check("plan", group_tasks=(0, 1))
    assert exc.value.site == "plan" and exc.value.index == 1
    assert exc.value.context == {"group_tasks": (0, 1)}
    fires = []
    for _trial in range(2):
        t = FaultInjector(rates={"dispatch": 0.5}, seed=7)
        row = []
        for _i in range(50):
            try:
                t.check("dispatch")
                row.append(False)
            except InjectedFault:
                row.append(True)
        fires.append(row)
    assert fires[0] == fires[1]
    assert any(fires[0]) and not all(fires[0])


def test_fault_injector_validation_and_cap():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(rates={"teleport": 0.1})
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(script={"teleport": {0}})
    with pytest.raises(ValueError, match="must be in"):
        FaultInjector(rates={"plan": 1.5})
    inj = FaultInjector(rates={"plan": 1.0}, max_faults=2)
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.check("plan")
    inj.check("plan")  # capped: no more faults
    assert inj.total_injected == 2 and inj.invocations["plan"] == 3


def test_retry_policy_backoff():
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_base=-0.1)
    p = RetryPolicy(backoff_base=0.1, backoff_factor=2.0, backoff_max=0.3)
    assert p.backoff_seconds(0) == pytest.approx(0.1)
    assert p.backoff_seconds(1) == pytest.approx(0.2)
    assert p.backoff_seconds(5) == pytest.approx(0.3)  # capped
    assert RetryPolicy().backoff_seconds(3) == 0.0     # base 0 => no sleep


def test_session_backoff_uses_sleep_hook():
    slept = []
    eng = _engine(fault_injector=FaultInjector(script={"load": {0, 1}}))
    s = eng.session(
        retry=RetryPolicy(max_retries=2, backoff_base=0.25, backoff_max=1.0),
        sleep=slept.append,
    )
    fut = s.submit(MultitaskRequest(x=np.zeros(DIM, np.float32)))
    s.drain()
    assert fut.error() is None
    assert slept == [pytest.approx(0.25), pytest.approx(0.5)]
    assert s.backoff_seconds == pytest.approx(0.75)


# --------------------------------------------------------------------------
# The session stays usable after a mid-pump failure
# --------------------------------------------------------------------------

def test_session_usable_after_mid_pump_failure():
    rng = np.random.default_rng(21)
    reqs = _requests(rng, [None, (0,), (1, 2), (0, 3), None, (1, 2)])
    ref = _reference_outputs(reqs)
    # Dense enough to exhaust the retries and the unfused rung of the group
    # that dispatches first ("plan" fires on every attempt).
    eng = _engine(fault_injector=FaultInjector(script={"plan": {0, 1, 2}}))
    session = eng.session(retry=RetryPolicy(max_retries=1, degrade=True))
    futs = [session.submit(r) for r in reqs]
    session.drain()

    failed = [f for f in futs if f.error() is not None]
    served = [(f, r) for f, r in zip(futs, ref) if f.error() is None]
    assert failed and served
    for f in failed:
        err = f.error()
        assert isinstance(err, RequestError)
        assert err.seq == f.seq and err.group_id is not None
        assert isinstance(err.__cause__, InjectedFault)
    for f, r in served:
        _assert_allclose_response(f.result(), r)
    assert session.groups_failed == 1
    assert session.stats == session.predicted

    eng.fault_injector = None
    futs2 = [session.submit(r) for r in reqs]
    session.drain()
    for f, r in zip(futs2, ref):
        _assert_allclose_response(f.result(), r)
    assert session.pending_count() == 0
    assert session.stats == session.predicted


def test_rollback_keeps_counters_exact_through_transient_faults():
    rng = np.random.default_rng(22)
    reqs = _requests(rng, [None, (1, 2), (0, 3), None, (0,), (1, 2), (2, 1)])
    ref = _reference_outputs(reqs)
    inj = FaultInjector(script={"plan": {1}, "load": {2}, "dispatch": {3}})
    session = _engine(fault_injector=inj).session(retry=RetryPolicy(max_retries=3))
    futs = [session.submit(r) for r in reqs]
    session.drain()
    for f, r in zip(futs, ref):
        resp = f.result()
        assert resp.degraded is None
        _assert_allclose_response(resp, r)
    assert session.group_retries >= 1
    assert session.groups_failed == 0
    assert session.stats == session.predicted


def test_degraded_unfused_run_matches_and_stays_exact():
    rng = np.random.default_rng(23)
    reqs = _requests(rng, [None, None])
    ref = _reference_outputs(reqs)
    inj = FaultInjector(rates={"dispatch": 1.0}, max_faults=2, seed=5)
    eng = _engine(fault_injector=inj)
    session = eng.session(retry=RetryPolicy(max_retries=1, degrade=True))
    futs = [session.submit(r) for r in reqs]
    session.drain()
    resp = futs[0].result()
    assert resp.degraded == "unfused" and resp.retries == 2
    for f, r in zip(futs, ref):
        _assert_allclose_response(f.result(), r)
    assert session.degraded_runs == 1
    assert session.stats == session.predicted
    assert eng.executor.fused  # the rung restores fused dispatch


def test_rollback_restores_pre_attempt_residency():
    """A group that exhausts the ladder leaves the executor exactly as it
    found it, even though its failed attempts loaded blocks."""
    rng = np.random.default_rng(24)
    eng = _engine()
    eng.serve(MultitaskRequest(x=_x(rng), tasks=(0,)))
    pre = eng.executor.residency_state()
    eng.fault_injector = FaultInjector(script={"dispatch": {1, 3, 5}})
    session = eng.session(retry=RetryPolicy(max_retries=1))
    fut = session.submit(MultitaskRequest(x=_x(rng), tasks=(2, 3)))
    session.drain()
    assert isinstance(fut.error(), RequestError)
    assert eng.executor.residency_state() == pre
    assert session.stats == session.predicted == type(session.stats)()


# --------------------------------------------------------------------------
# Deadlines, backpressure, tenants
# --------------------------------------------------------------------------

def test_deadline_expiry_before_planning():
    clock = FakeClock()
    session = _engine().session(
        policy=WindowPolicy(max_wait=10.0, max_group_size=4), clock=clock)
    x = _x(np.random.default_rng(24))
    f_dead = session.submit(MultitaskRequest(x, deadline=1.0, tenant="a"))
    f_live = session.submit(MultitaskRequest(x, tenant="b"))
    clock.advance(2.0)
    session.step()
    assert isinstance(f_dead.error(), DeadlineExceeded)
    assert f_dead.error().tenant == "a"
    assert not f_live.done()
    session.drain()
    assert f_live.error() is None
    assert session.requests_expired == 1
    assert session.tenant_stats("a").expired == 1
    assert session.tenant_stats("b").admitted == 1
    assert session.stats == session.predicted


def test_backpressure_reject_and_shed():
    x = _x(np.random.default_rng(25))
    s_rej = _engine().session(max_pending=2, overload="reject")
    f1, f2 = (s_rej.submit(MultitaskRequest(x)) for _ in range(2))
    f3 = s_rej.submit(MultitaskRequest(x, priority=99))
    err = f3.error()
    assert isinstance(err, QueueFull) and not err.shed
    assert s_rej.pending_count() == 2 and s_rej.requests_rejected == 1
    s_rej.drain()
    assert f1.error() is None and f2.error() is None

    s_shed = _engine().session(max_pending=2, overload="shed")
    f_old = s_shed.submit(MultitaskRequest(x, priority=0))
    f_young = s_shed.submit(MultitaskRequest(x, priority=0))
    f_vip = s_shed.submit(MultitaskRequest(x, priority=1))
    assert isinstance(f_young.error(), QueueFull) and f_young.error().shed
    assert not f_old.done() and not f_vip.done()
    f_equal = s_shed.submit(MultitaskRequest(x, priority=0))
    assert isinstance(f_equal.error(), QueueFull) and not f_equal.error().shed
    s_shed.drain()
    assert f_old.error() is None and f_vip.error() is None
    assert s_shed.requests_shed == 1 and s_shed.requests_rejected == 1


def test_per_tenant_quota_and_wait_aggregates():
    clock = FakeClock()
    session = _engine().session(clock=clock, max_pending_per_tenant=2)
    x = _x(np.random.default_rng(26))
    fa = [session.submit(MultitaskRequest(x, tenant="a")) for _ in range(3)]
    fb = session.submit(MultitaskRequest(x, tenant="b"))
    assert isinstance(fa[2].error(), QueueFull)
    assert fa[2].error().tenant == "a"
    assert not fb.done()
    clock.advance(1.5)
    session.drain()
    ts_a, ts_b = session.tenant_stats("a"), session.tenant_stats("b")
    assert ts_a.submitted == 3 and ts_a.admitted == 2 and ts_a.rejected == 1
    assert ts_b.submitted == 1 and ts_b.admitted == 1
    assert ts_a.mean_admission_wait == pytest.approx(1.5)
    assert ts_a.max_admission_wait == pytest.approx(1.5)
    assert session.tenant_mean_admission_wait("b") == pytest.approx(1.5)
    assert session.tenant_max_admission_wait("b") == pytest.approx(1.5)
    assert session.mean_admission_wait == pytest.approx(1.5)
    assert session.max_admission_wait == pytest.approx(1.5)
    assert TenantStats().mean_admission_wait == 0.0


def test_slo_aware_policy_orders_by_urgency_and_affinity():
    clock = FakeClock()
    policy = SloAwarePolicy(max_group_size=4, min_pending=99, slack_threshold=0.5)
    session = _engine().session(policy=policy, clock=clock)
    rng = np.random.default_rng(27)
    f_lazy = session.submit(MultitaskRequest(_x(rng), tasks=(0,)))
    f_urgent = session.submit(MultitaskRequest(_x(rng), tasks=(1, 2), deadline=0.4))
    done = session.step()  # slack 0.4 <= 0.5 fires below the thresholds
    assert f_urgent.done() and f_urgent.error() is None
    assert not f_lazy.done()
    assert len(done) == 1
    session.drain()
    assert f_lazy.error() is None
    assert session.stats == session.predicted


def test_slo_aware_policy_starvation_override():
    clock = FakeClock()
    policy = SloAwarePolicy(max_group_size=2, min_pending=2, starvation_wait=5.0)
    session = _engine().session(policy=policy, clock=clock)
    x = _x(np.random.default_rng(28))
    f_starved = session.submit(MultitaskRequest(x, tasks=(0, 3), tenant="b"))
    clock.advance(6.0)
    f_fresh = session.submit(MultitaskRequest(x, tasks=(0,), tenant="a"))
    session.step()
    assert f_starved.done() and f_starved.error() is None
    assert not f_fresh.done()
    session.drain()
    assert f_fresh.error() is None


def test_session_validation():
    eng = _engine()
    with pytest.raises(ValueError, match="overload"):
        eng.session(overload="panic")
    with pytest.raises(ValueError, match="max_pending"):
        eng.session(max_pending=0)
    with pytest.raises(ValueError, match="max_pending_per_tenant"):
        eng.session(max_pending_per_tenant=0)


# --------------------------------------------------------------------------
# Property: never stranded, correct when served, exact when succeeded
# --------------------------------------------------------------------------

def _chaos_requests(request_cls, subset_idx, deadlines, priorities, seed, to_x):
    rng = np.random.default_rng(seed)
    return [request_cls(
        x=to_x(rng.normal(size=(DIM,)).astype(np.float32)),
        tasks=SUBSET_CHOICES[s % len(SUBSET_CHOICES)],
        deadline=deadlines[i % len(deadlines)] if deadlines else None,
        priority=priorities[i % len(priorities)] if priorities else 0,
        tenant=("t0", "t1", None)[i % 3],
    ) for i, s in enumerate(subset_idx)]


def _chaos_session(engine, pol, rel, requests, fault_seed, rates, policy_idx, max_retries):
    """One chaos scenario through ``engine``: arrivals 0.125 s apart on a
    simulated clock, a step after each, then a drain."""
    policy = (
        pol.GreedyBatchPolicy(),
        pol.WindowPolicy(max_wait=0.5, max_group_size=4),
        pol.AffinityPolicy(max_group_size=4, min_pending=2),
        pol.SloAwarePolicy(max_group_size=4, min_pending=2, slack_threshold=0.25),
    )[policy_idx % 4]
    engine.fault_injector = rel.FaultInjector(rates=rates, seed=fault_seed)
    rec = Recorder(policy, engine)
    clock = FakeClock()
    session = engine.session(policy=rec, clock=clock, max_pending=6, overload="shed",
                             retry=rel.RetryPolicy(max_retries=max_retries))
    futs = []
    for r in requests:
        futs.append(session.submit(r))
        clock.advance(0.125)
        session.step()
    session.drain()
    return session, futs, rec


def _run_chaos_scenario(subset_idx, deadlines, priorities, fault_seed,
                        rates, policy_idx, max_retries):
    reqs = _chaos_requests(MultitaskRequest, subset_idx, deadlines, priorities,
                           fault_seed, lambda a: a)
    ref = _reference_outputs(reqs)
    session, futs, _rec = _chaos_session(_engine(), p_pol, p_rel, reqs, fault_seed,
                                         rates, policy_idx, max_retries)
    for f, r in zip(futs, ref):
        assert f.done(), f"future {f.seq} stranded"
        if f.error() is None:
            _assert_allclose_response(f.result(), r)
        else:
            assert isinstance(f.error(), RequestError)
    assert session.pending_count() == 0
    assert session.stats == session.predicted
    assert session.requests_submitted == (
        session.requests_admitted + session.requests_rejected
        + session.requests_shed + session.requests_expired
    )


def _chaos_trials(seed, n_trials):
    rng = np.random.default_rng(seed)
    for trial in range(n_trials):
        n = int(rng.integers(3, 10))
        yield dict(
            subset_idx=[int(i) for i in rng.integers(0, len(SUBSET_CHOICES), n)],
            deadlines=(
                [float(d) for d in rng.uniform(0.1, 3.0, 3)] if trial % 2 else []
            ),
            priorities=[int(p) for p in rng.integers(0, 3, 3)],
            fault_seed=int(rng.integers(0, 2**31)),
            rates={
                "plan": float(rng.uniform(0, 0.2)),
                "load": float(rng.uniform(0, 0.2)),
                "dispatch": float(rng.uniform(0, 0.1)),
            },
            policy_idx=trial,
            max_retries=int(rng.integers(0, 3)),
        )


def test_chaos_property_fallback():
    for scenario in _chaos_trials(99, 6):
        _run_chaos_scenario(**scenario)


@settings(max_examples=15, deadline=None, derandomize=True, database=None)
@given(
    subset_idx=st.lists(
        st.integers(0, len(SUBSET_CHOICES) - 1), min_size=2, max_size=8),
    deadlines=st.lists(st.floats(0.1, 3.0, allow_nan=False), max_size=3),
    priorities=st.lists(st.integers(0, 3), max_size=3),
    fault_seed=st.integers(0, 2**31 - 1),
    plan_rate=st.floats(0.0, 0.25),
    dispatch_rate=st.floats(0.0, 0.15),
    policy_idx=st.integers(0, 3),
    max_retries=st.integers(0, 2),
)
def test_chaos_property(subset_idx, deadlines, priorities, fault_seed,
                        plan_rate, dispatch_rate, policy_idx, max_retries):
    _run_chaos_scenario(
        subset_idx, deadlines, priorities, fault_seed,
        {"plan": plan_rate, "dispatch": dispatch_rate}, policy_idx, max_retries,
    )


# --------------------------------------------------------------------------
# Held against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_injector_schedule_equals_reference(seed):
    """The same seed, rates, script and cap give the same faults, call for
    call, with the same indices, contexts and counters."""
    rates = {"plan": 0.3, "load": 0.2, "dispatch": 0.4}
    script = {"load": {3, 5}}
    injectors = [mod.FaultInjector(rates=rates, seed=seed, script=script, max_faults=25)
                 for mod in (r_rel, p_rel)]
    sites = np.random.default_rng(seed).choice(["plan", "load", "dispatch"], size=200)
    logs = []
    for inj, exc_type in zip(injectors, (r_rel.InjectedFault, p_rel.InjectedFault)):
        log = []
        for i, site in enumerate(sites):
            try:
                inj.check(str(site), call=i)
                log.append(None)
            except exc_type as e:
                log.append((e.site, e.index, e.context))
        logs.append((log, dict(inj.invocations), dict(inj.injected)))
    assert logs[0] == logs[1]
    assert logs[0][2]["dispatch"] > 0


def test_retry_policy_and_tenant_stats_equal_reference():
    for kwargs in ({}, {"backoff_base": 0.1}, {"backoff_base": 0.05, "backoff_factor": 3.0,
                                               "backoff_max": 0.7, "max_retries": 5}):
        r, p = r_rel.RetryPolicy(**kwargs), p_rel.RetryPolicy(**kwargs)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert [r.backoff_seconds(a) for a in range(8)] == [p.backoff_seconds(a) for a in range(8)]
    fields = [f.name for f in dataclasses.fields(r_rel.TenantStats)]
    assert fields == [f.name for f in dataclasses.fields(p_rel.TenantStats)]
    assert r_rel.FAULT_SITES == p_rel.FAULT_SITES
    assert r_rel.POWER_SITES == p_rel.POWER_SITES


def test_energy_budget_and_power_injector_equal_reference():
    """Copied now for the intermittent-power slice: the same arithmetic and
    the same seeded schedule."""
    budgets = [mod.EnergyBudget(capacity_joules=2.0, harvest_watts=0.5, initial_joules=0.25)
               for mod in (r_rel, p_rel)]
    for b in budgets:
        b.harvest(0.0)
        b.harvest(1.5)
        b.advance(b.seconds_until(1.9))
        b.drain(1.2)
    assert [vars(b) for b in budgets][0] == [vars(b) for b in budgets][1]
    fired = []
    for mod in (r_rel, p_rel):
        inj = mod.PowerFailureInjector(rates={"group": 0.3, "suffix": 0.2}, seed=3)
        row = []
        for i in range(60):
            try:
                inj.check(("group", "suffix", "prefetch")[i % 3])
                row.append(False)
            except mod.PowerFailure:
                row.append(True)
        fired.append(row)
    assert fired[0] == fired[1] and any(fired[0])


@pytest.mark.parametrize("trial", range(4))
def test_chaos_scenario_matches_reference(trial):
    """One seeded chaos scenario (rates, deadlines, priorities, shedding)
    through the reference's session and the port's: the same rounds,
    attempts, outcomes, retries, rungs and counters."""
    scenario = list(_chaos_trials(7, 4))[trial]
    runs = []
    for engine_mod, pol, rel, engine, to_x in (
        (r_engine, r_pol, r_rel,
         r_engine.MultitaskEngine(R_PROGRAM, hw=R_MSP430,
                                  scheduler=RScheduler(batch_shapes=(1, 4))), jnp.asarray),
        (p_engine, p_pol, p_rel, _engine(), lambda a: a),
    ):
        reqs = _chaos_requests(engine_mod.MultitaskRequest, scenario["subset_idx"],
                               scenario["deadlines"], scenario["priorities"],
                               scenario["fault_seed"], to_x)
        runs.append(_chaos_session(
            engine, pol, rel, reqs, scenario["fault_seed"], scenario["rates"],
            scenario["policy_idx"], scenario["max_retries"]))
    (ref, ref_futs, ref_rec), (port, port_futs, port_rec) = runs
    assert port_rec.rounds == ref_rec.rounds
    assert port_rec.attempts == ref_rec.attempts
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.engine.fault_injector.injected == ref.engine.fault_injector.injected
    for name in ("requests_admitted", "requests_rejected", "requests_shed",
                 "requests_expired", "requests_failed", "groups_executed",
                 "groups_failed", "group_retries", "degraded_runs"):
        assert getattr(port, name) == getattr(ref, name), name
    for rf, pf in zip(ref_futs, port_futs):
        assert type(pf.error()).__name__ == type(rf.error()).__name__
        if rf.error() is None:
            r, p = rf.result(), pf.result()
            assert (p.retries, p.degraded, p.effective_order) == (
                r.retries, r.degraded, r.effective_order)
            for t in r.outputs:
                np.testing.assert_allclose(
                    p.outputs[t].numpy(), np.asarray(r.outputs[t]), rtol=1e-5, atol=1e-5)

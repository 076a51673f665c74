"""The port's planner stack against the reference's.

``core/memory.py``, ``core/simulator.py``, ``core/mixed.py``,
``core/search.py`` and ``api/{cluster,plan,planner}.py`` are numpy copies;
these tests pin them to the reference on the same models (the reference's,
carried across with ``convert_model``): memory tables and peaks, simulated
timelines and dependency edges, ``measured_kc``, the mixing DP, and
``Plan.to_json`` — equal but for the search's wall-clock time — for the
ladder, the beam, both transports and mixed subsets.  The committed
plan-search outcomes of ``BENCH_executor.json`` hold in the port as they do
in ``tests/test_search.py``, and a port ``Plan`` compiled on the CPU serves
the reference's ``Plan.compile()`` output bit for bit.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
import repro.core.memory as RM
import repro.core.mixed as RX
import repro.core.simulator as RS
from conftest import small_cnn
from repro.api import Cluster as RefCluster
from repro.api import InfeasibleError as RefInfeasible
from repro.api import Objective as RefObjective
from repro.api import Planner as RefPlanner
from repro.models import mobilenet_v2_smoke as ref_mnv2_smoke

import repro_torch.core as T
import repro_torch.core.memory as TM
import repro_torch.core.mixed as TX
import repro_torch.core.simulator as TS
from repro_torch.api import (SEARCH_MODES, Cluster, InfeasibleError,
                             Objective, Plan, Planner)
from repro_torch.convert import convert_model, convert_qmodel
from repro_torch.models import mobilenet_v2_paper, mobilenet_v2_smoke

BENCH = json.loads(
    (pathlib.Path(__file__).parent.parent / "BENCH_executor.json")
    .read_text())
RAM_CAP = 512 * 1024
MODES = ("neuron", "kernel", "spatial")
RATINGS = {1: [1.0], 3: [1.0, 0.6, 1.4], 8: [1.0, 0.8, 1.2, 0.6, 1.4, 0.9,
                                             1.1, 0.7]}


@pytest.fixture(scope="module", params=["small_cnn", "mnv2_smoke"])
def models(request):
    ref = small_cnn() if request.param == "small_cnn" else ref_mnv2_smoke()
    return request.param, ref, convert_model(ref)


def _splits(ref_model, model, mode, n, fused=True):
    r = np.asarray(RATINGS[n])
    return (R.split_model(ref_model, r, mode=mode, fused=fused),
            T.split_model(model, r, mode=mode, fused=fused))


def _mixed_splits(ref_model, model, n):
    n_b = len(R.group_blocks(ref_model))
    assignment = [MODES[i % 3] for i in range(n_b)]
    r = np.asarray(RATINGS[n])
    return (R.split_model_mixed(ref_model, r, assignment),
            T.split_model_mixed(model, r, assignment))


def _same(a, b, path="") -> None:
    """Deep equality of plain values, numpy arrays and dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (set, frozenset)):
        assert a == b, path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

class TestMemory:
    @pytest.mark.parametrize("n", [1, 3, 8])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_tables_and_peaks(self, models, mode, n):
        _, ref_model, model = models
        rs, ts = (_mixed_splits(ref_model, model, n) if mode == "mixed"
                  else _splits(ref_model, model, mode, n))
        for itemsize in (1, 4):
            _same(RM.plan_memory(rs, itemsize), TM.plan_memory(ts, itemsize))
            _same(RM.layerwise_peak(rs, itemsize),
                  TM.layerwise_peak(ts, itemsize))
            _same(RM.peak_ram_per_worker(rs, itemsize),
                  TM.peak_ram_per_worker(ts, itemsize))
        for rsp, tsp in zip(rs.splits, ts.splits):
            _same(RM.split_memory(rsp), TM.split_memory(tsp))
        assert RM.single_device_peak(ref_model) == TM.single_device_peak(
            model)


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------

class TestSimulator:
    @pytest.mark.parametrize("transport", ["serial", "pipelined"])
    @pytest.mark.parametrize("n", [1, 3, 8])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_simulate_equal(self, models, mode, n, transport):
        _, ref_model, model = models
        rs, ts = (_mixed_splits(ref_model, model, n) if mode == "mixed"
                  else _splits(ref_model, model, mode, n))
        rw = list(RefCluster.heterogeneous_demo(n).workers)
        tw = list(Cluster.heterogeneous_demo(n).workers)
        r = np.asarray(RATINGS[n])
        ref = RS.simulate(ref_model, rw, r, RS.SimConfig(transport=transport),
                          plan=rs)
        got = TS.simulate(model, tw, r, TS.SimConfig(transport=transport),
                          plan=ts)
        _same(ref, got)
        assert ref.total_time == got.total_time
        assert ref.overlap_saved_s == got.overlap_saved_s

    @pytest.mark.parametrize("n", [1, 3, 8])
    @pytest.mark.parametrize("fused", [True, False])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_dependencies(self, models, mode, n, fused):
        _, ref_model, model = models
        rs, ts = (_mixed_splits(ref_model, model, n) if mode == "mixed"
                  else _splits(ref_model, model, mode, n, fused))
        assert RS.dependency_edges(rs) == TS.dependency_edges(ts)
        _same(RS.pipelined_dependencies(rs), TS.pipelined_dependencies(ts))
        _same(RS._segments(rs), TS._segments(ts))

    @pytest.mark.parametrize("n", [1, 2, 5, 8])
    def test_measured_kc_and_k1(self, models, n):
        _, ref_model, model = models
        assert RS.measured_kc(ref_model, n) == TS.measured_kc(model, n)
        assert (RS.simulated_k1(ref_model, 600.0)
                == TS.simulated_k1(model, 600.0))

    def test_compare_modes(self, models):
        _, ref_model, model = models
        rw = list(RefCluster.heterogeneous_demo(3).workers)
        tw = list(Cluster.heterogeneous_demo(3).workers)
        _same(RS.compare_modes(ref_model, rw), TS.compare_modes(model, tw))


# ---------------------------------------------------------------------------
# mixing DP
# ---------------------------------------------------------------------------

class TestMixed:
    @pytest.mark.parametrize("transport", ["serial", "pipelined"])
    @pytest.mark.parametrize("minimize", ["latency", "comm_bytes",
                                          "peak_ram"])
    @pytest.mark.parametrize("n", [1, 3, 8])
    def test_search_equal(self, models, n, minimize, transport):
        _, ref_model, model = models
        rw = list(RefCluster.heterogeneous_demo(n).workers)
        tw = list(Cluster.heterogeneous_demo(n).workers)
        r = np.asarray(RATINGS[n])
        subsets = (None,) if n == 1 else (None, 1, n - 1)
        ref = RX.search_mixed_assignment(ref_model, rw, r, minimize=minimize,
                                         transport=transport,
                                         subset_choices=subsets)
        got = TX.search_mixed_assignment(model, tw, r, minimize=minimize,
                                         transport=transport,
                                         subset_choices=subsets)
        _same(ref, got)

    def test_infeasible_equal(self, models):
        _, ref_model, model = models
        rw = list(RefCluster.heterogeneous_demo(2).workers)
        tw = list(Cluster.heterogeneous_demo(2).workers)
        caps = np.full(2, 64)
        with pytest.raises(RX.MixedInfeasible) as ref:
            RX.search_mixed_assignment(ref_model, rw, ram_caps=caps)
        with pytest.raises(TX.MixedInfeasible) as got:
            TX.search_mixed_assignment(model, tw, ram_caps=caps)
        assert str(ref.value) == str(got.value)


# ---------------------------------------------------------------------------
# planner: Plan.to_json equal to the reference's
# ---------------------------------------------------------------------------

OBJECTIVES = {
    "ladder": dict(),
    "serial": dict(transports=("serial",)),
    "pipelined": dict(transports=("pipelined",)),
    "beam4": dict(beam_width=4),
    "mixed": dict(modes=("neuron", "kernel", "spatial", "mixed")),
    "mixed_subsets": dict(modes=("neuron", "kernel", "spatial", "mixed"),
                          mixed_subsets=2),
    "comm_bytes": dict(minimize="comm_bytes"),
}


def _plan_dict(plan) -> dict:
    """``Plan.to_dict`` minus the search's wall-clock time."""
    d = json.loads(plan.to_json())
    if d.get("search_stats"):
        d["search_stats"].pop("search_wall_s")
    return d


def _plan_both(ref_model, model, k, kw):
    ref_obj = RefObjective(ram_cap_bytes=RAM_CAP, **kw)
    obj = Objective(ram_cap_bytes=RAM_CAP, **kw)
    try:
        ref = RefPlanner(ref_model, RefCluster.heterogeneous_demo(k)).plan(
            ref_obj)
    except RefInfeasible as e:
        with pytest.raises(InfeasibleError) as ei:
            Planner(model, Cluster.heterogeneous_demo(k)).plan(obj)
        assert ei.value.binding_constraint == e.binding_constraint
        assert str(ei.value) == str(e)
        return None, None
    return ref, Planner(model, Cluster.heterogeneous_demo(k)).plan(obj)


class TestPlanner:
    @pytest.mark.parametrize("objective", sorted(OBJECTIVES))
    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_plan_json_equal(self, models, k, objective):
        _, ref_model, model = models
        ref, got = _plan_both(ref_model, model, k, OBJECTIVES[objective])
        if ref is None:
            return
        assert _plan_dict(got) == _plan_dict(ref)
        _same(got.worker_geometry(), ref.worker_geometry())

    def test_cluster_round_trip_matches_reference(self):
        c = Cluster.heterogeneous_demo(5)
        assert c.to_dict() == RefCluster.heterogeneous_demo(5).to_dict()
        assert Cluster.from_dict(json.loads(json.dumps(c.to_dict()))) == c

    @pytest.mark.parametrize("objective", ["ladder", "mixed_subsets"])
    def test_from_json_round_trips(self, models, objective):
        _, ref_model, model = models
        plan = Planner(model, Cluster.heterogeneous_demo(3)).plan(
            Objective(ram_cap_bytes=RAM_CAP, **OBJECTIVES[objective]))
        again = Plan.from_json(plan.to_json(), model)
        assert again.to_json() == plan.to_json()
        _same(again.split.block_groups, plan.split.block_groups)
        # the reference reads the port's payload, and the other way round
        from repro.api import Plan as RefPlan
        ref_again = RefPlan.from_json(plan.to_json(), ref_model)
        assert ref_again.to_json() == plan.to_json()


# ---------------------------------------------------------------------------
# the committed plan-search outcomes (tests/test_search.py's pins)
# ---------------------------------------------------------------------------

class TestCommittedOutcomes:
    def _check(self, model, config, k):
        want = BENCH["planner"][f"{config}@{k}"]
        planner = Planner(model, Cluster.heterogeneous_demo(k))
        objective = Objective(minimize="latency", ram_cap_bytes=RAM_CAP)
        if not want["feasible"]:
            with pytest.raises(InfeasibleError) as ei:
                planner.plan(objective)
            assert ei.value.binding_constraint == want["binding"]
            return
        plan = planner.plan(objective)
        got = dict(plan_latency_s=round(plan.latency_s, 9),
                   max_peak_ram=int(plan.max_peak_ram),
                   mode=plan.mode, fusion=plan.fusion,
                   transport=plan.transport,
                   overlap_saved_s=round(plan.overlap_saved_s, 9),
                   n_workers=plan.n_workers)
        assert got == {k_: want[k_] for k_ in got}

    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_smoke_configs(self, k):
        self._check(mobilenet_v2_smoke(), "smoke", k)

    @pytest.mark.parametrize("k", [1, 3])
    def test_mnv2_112_configs(self, k):
        self._check(mobilenet_v2_paper(), "mnv2_112", k)


# ---------------------------------------------------------------------------
# Plan.compile serves the reference's output
# ---------------------------------------------------------------------------

class TestCompile:
    @pytest.mark.parametrize("k", [1, 3])
    def test_compile_on_cpu_equals_reference(self, models, k):
        _, ref_model, model = models
        ref_plan = RefPlanner(ref_model, RefCluster.heterogeneous_demo(k)
                              ).plan(RefObjective(ram_cap_bytes=RAM_CAP))
        plan = Planner(model, Cluster.heterogeneous_demo(k)).plan(
            Objective(ram_cap_bytes=RAM_CAP))
        ref_sess = ref_plan.compile()
        sess = plan.compile(qmodel=convert_qmodel(ref_sess.qmodel, model),
                            device="cpu", max_batch=4)
        assert sess.plan is plan and sess.transport == plan.transport
        rng = np.random.default_rng(k)
        xs = rng.standard_normal((3, *model.input_shape)).astype(np.float32)
        got = sess.submit_many(xs)
        assert got.dtype == np.int8
        assert np.array_equal(got, ref_sess.submit_many(xs))
        st, ref_st = sess.stats(), ref_sess.stats()
        assert st.transport == ref_st.transport
        assert st.predicted_overlap_saved_s == ref_st.predicted_overlap_saved_s
        assert (st.search_candidates_evaluated
                == ref_st.search_candidates_evaluated)
        assert st.search_cache_hit_rate == ref_st.search_cache_hit_rate

    def test_compile_float_close_to_reference(self, models):
        _, ref_model, model = models
        ref_plan = RefPlanner(ref_model, RefCluster.heterogeneous_demo(3)
                              ).plan(RefObjective(ram_cap_bytes=RAM_CAP))
        plan = Planner(model, Cluster.heterogeneous_demo(3)).plan(
            Objective(ram_cap_bytes=RAM_CAP))
        x = np.random.default_rng(5).standard_normal(
            (2, *model.input_shape)).astype(np.float32)
        got = plan.compile("float", device="cpu").submit_many(x)
        want = ref_plan.compile("float").submit_many(x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_search_modes_export(self):
        from repro.api.planner import SEARCH_MODES as REF_SEARCH_MODES
        assert SEARCH_MODES == REF_SEARCH_MODES

"""The port's elastic runtime (``runtime/elastic.py``, ``runtime/replan.py``)
against the reference's, on the CPU.

``ElasticCluster`` replans over the same survivors to the same plans;
``diff_plans`` classifies the same shards and counts the same reshipped
bytes for the same topology change; a churn — a worker killed mid-stream,
a straggler demoted, the dead worker rejoining — served by the port's
``ElasticCoordinator`` stays bit-exact with the port's ``Session`` on each
surviving topology, hits the warm segment cache at rate 1.0 on unchanged
geometry, reships fewer bytes than a full setup, and reships exactly what
the reference's coordinator reships through the same churn.
"""
import asyncio
import json

import numpy as np
import pytest

import repro.core as R
from conftest import small_cnn
from repro.api import Session as RefSession
from repro.api.planner import Objective as RefObjective
from repro.core.allocation import WorkerParams as RefWorkerParams
from repro.runtime.elastic import ElasticCluster as RefElasticCluster
from repro.runtime.replan import ElasticCoordinator as RefElasticCoordinator
from repro.runtime.replan import diff_plans as ref_diff_plans

import repro_torch.core as T
from repro_torch.api import Session
from repro_torch.api.planner import Objective
from repro_torch.convert import convert_model, convert_qmodel
from repro_torch.core.allocation import WorkerParams
from repro_torch.runtime.elastic import ClusterCollapsed, ElasticCluster
from repro_torch.runtime.replan import ElasticCoordinator, diff_plans
from repro_torch.serve.admission import Overloaded

pytestmark = pytest.mark.xdist_group("runtime")

TIMEOUT = 240
F_MHZ = (600.0, 300.0, 450.0, 150.0)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


@pytest.fixture(scope="module")
def cnn():
    ref_model = small_cnn()
    model = convert_model(ref_model)
    ref_q = RefSession(R.split_model(ref_model, np.ones(2)),
                       seed=0).qmodel
    return ref_model, model, ref_q, convert_qmodel(ref_q, model)


def _clusters(ref_model, model, n, modes=("spatial",)):
    kw = dict(heartbeat_timeout=1e9, clock=lambda: 0.0)
    ref = RefElasticCluster(
        ref_model, [RefWorkerParams(f_mhz=f) for f in F_MHZ[:n]],
        objective=RefObjective(modes=modes), **kw)
    got = ElasticCluster(model, [WorkerParams(f_mhz=f) for f in F_MHZ[:n]],
                         objective=Objective(modes=modes), **kw)
    return ref, got


def _plan_dict(plan) -> dict:
    d = json.loads(plan.to_json())
    d["search_stats"].pop("search_wall_s")
    return d


class TestElasticCluster:
    @pytest.mark.parametrize("modes", [("spatial",),
                                       ("neuron", "kernel", "spatial")])
    def test_policy_replans_equal_reference(self, cnn, modes):
        ref_model, model, _, _ = cnn
        ref, got = _clusters(ref_model, model, 4, modes)
        assert _plan_dict(got.plan) == _plan_dict(ref.plan)
        assert got.plan_worker_ids == ref.plan_worker_ids
        for c in (ref, got):                # a death, then a straggler
            c.mark_failed(1)
            c.check(now=0.0)
        assert got.plan_worker_ids == ref.plan_worker_ids
        assert _plan_dict(got.plan) == _plan_dict(ref.plan)
        for c in (ref, got):
            for w in c.alive_indices:
                c.report_step_time(w, 10.0 if w == 2 else 1.0)
            assert c.check(now=0.0)
        assert got.health[2].params.f_mhz == ref.health[2].params.f_mhz
        assert _plan_dict(got.plan) == _plan_dict(ref.plan)
        for c in (ref, got):
            c.rejoin(1, now=0.0)
            c.check(now=0.0)
        assert got.plan_worker_ids == ref.plan_worker_ids
        assert _plan_dict(got.plan) == _plan_dict(ref.plan)
        assert (got.last_search_stats["candidates_evaluated"]
                == ref.last_search_stats["candidates_evaluated"])

    def test_collapse_is_typed(self, cnn):
        _, model, _, _ = cnn
        c = ElasticCluster(model, [WorkerParams()], heartbeat_timeout=1e9,
                           clock=lambda: 0.0)
        c.mark_failed(0)
        with pytest.raises(ClusterCollapsed):
            c.check(now=0.0)


class TestPlanDiff:
    @pytest.mark.parametrize("precision", ["int8", "float"])
    @pytest.mark.parametrize("old_n,new_n,mode", [
        (3, 2, "spatial"), (2, 3, "spatial"), (3, 2, "neuron"),
        (2, 2, "kernel"), (4, 3, "spatial")])
    def test_diff_equal_reference(self, cnn, old_n, new_n, mode, precision):
        ref_model, model, ref_q, q = cnn
        int8 = precision == "int8"
        wmap = {w: w + 1 for w in range(min(old_n, new_n) - 1)}
        ref = ref_diff_plans(
            R.split_model(ref_model, np.ones(old_n), mode=mode),
            R.split_model(ref_model, np.ones(new_n), mode=mode),
            qmodel=ref_q if int8 else None, precision=precision,
            worker_map=wmap)
        got = diff_plans(
            T.split_model(model, np.ones(old_n), mode=mode),
            T.split_model(model, np.ones(new_n), mode=mode),
            qmodel=q if int8 else None, precision=precision,
            worker_map=wmap)
        assert [vars(e) for e in got.entries] == [vars(e)
                                                  for e in ref.entries]
        assert (got.removed, got.full_setup_bytes, got.reshipped_bytes) == (
            ref.removed, ref.full_setup_bytes, ref.reshipped_bytes)
        assert got.summary() == ref.summary()

    def test_identity_diff_all_unchanged(self, cnn):
        _, model, _, q = cnn
        s = T.split_model(model, np.ones(3), mode="spatial")
        d = diff_plans(s, s, q)
        assert d.unchanged == len(d.entries) and d.reshipped_bytes == 0


async def _churn(coord):
    """Kill plan slot 0 mid-stream, demote a straggler, rejoin the dead
    worker; returns each phase's output, split and transition report."""
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(coord.split.model.input_shape)
          .astype(np.float32) for _ in range(2)]
    out = {"xs": xs, "y": [], "split": [], "reports": []}
    async with coord as ec:
        out["y"].append(await ec.infer(xs[0]))
        out["split"].append(ec.split)
        victim = ec.physical_ids[0]
        await ec.inject_failure(0)
        out["y"].append(await ec.infer(xs[1]))      # replan + retry inside
        out["split"].append(ec.split)
        out["reports"].append(ec.reports[-1])
        out["victim_gone"] = victim not in ec.cluster.plan_worker_ids
        out["reports"].append(await ec.rejoin(victim))
        out["y"].append(await ec.infer(xs[0]))
        out["split"].append(ec.split)
    return out


class TestChurn:
    def test_kill_rejoin_bitexact_and_reships_as_reference(self, cnn):
        ref_model, model, ref_q, q = cnn
        ref_cluster, cluster = _clusters(ref_model, model, 3)
        got = run(_churn(ElasticCoordinator(cluster, q, spawn="inprocess",
                                            device="cpu")))
        want = run(_churn(RefElasticCoordinator(ref_cluster, ref_q,
                                                spawn="inprocess")))
        for i, (y, split) in enumerate(zip(got["y"], got["split"])):
            x = got["xs"][0 if i != 1 else 1]
            oracle = Session(split, qmodel=q, device="cpu")
            assert np.array_equal(y, oracle.run(x)), f"phase {i}"
            assert np.array_equal(y, want["y"][i]), f"phase {i} vs reference"
        assert got["victim_gone"] and want["victim_gone"]
        for rep, ref_rep in zip(got["reports"], want["reports"]):
            assert rep["reshipped_bytes"] < rep["full_setup_bytes"]
            assert rep["hit_rate"] == 1.0
            assert rep["cache_hits"] == rep["expected_cache_hits"]
            for key in ("reshipped_bytes", "full_setup_bytes",
                        "received_bytes", "cache_hits", "cache_misses",
                        "expected_cache_hits", "inherited", "spawned",
                        "retired", "plan_worker_ids"):
                assert rep[key] == ref_rep[key], key
        assert got["reports"][1]["cache_hits"] > 0
        assert got["reports"][1]["spawned"]

    def test_straggler_demotion_served_bitexact(self, cnn):
        _, model, _, q = cnn
        cluster = ElasticCluster(model, [WorkerParams() for _ in range(3)],
                                 objective=Objective(modes=("spatial",)),
                                 heartbeat_timeout=1e9)
        x = np.random.default_rng(4).standard_normal(
            model.input_shape).astype(np.float32)

        async def main():
            async with ElasticCoordinator(cluster, q, spawn="inprocess",
                                          device="cpu") as ec:
                before = ec.plan.ratings.copy()
                for slot in range(ec.split.n_workers):
                    ec.report_step_time(slot, 10.0 if slot == 1 else 1.0)
                rep = await ec.rebalance()
                return before, ec.plan.ratings, rep, await ec.infer(x), \
                    ec.split
        before, after, rep, y, split = run(main())
        assert after[1] < before[1]
        assert rep["hit_rate"] == 1.0
        assert np.array_equal(y, Session(split, qmodel=q,
                                         device="cpu").run(x))

    def test_queue_cap_sheds_typed(self, cnn):
        _, model, _, q = cnn
        cluster = ElasticCluster(model, [WorkerParams() for _ in range(2)],
                                 objective=Objective(modes=("spatial",)),
                                 heartbeat_timeout=1e9, clock=lambda: 0.0)
        ec = ElasticCoordinator(cluster, q, spawn="inprocess", queue_cap=0,
                                device="cpu")
        with pytest.raises(Overloaded) as ei:
            asyncio.run(ec.infer(np.zeros(model.input_shape, np.float32)))
        assert ei.value.reason == "rebalancing"
        assert ei.value.queue_depth == 0

    def test_session_facade_builds_elastic_coordinator(self, cnn):
        _, model, _, q = cnn
        sess = Session(T.split_model(model, np.ones(2)), qmodel=q,
                       device="cpu")
        ec = sess.distributed(elastic=True,
                              workers=[WorkerParams() for _ in range(2)],
                              objective=Objective(modes=("spatial",)),
                              spawn="inprocess")
        assert isinstance(ec, ElasticCoordinator)
        assert ec.qmodel is sess.qmodel and ec.plan.mode == "spatial"
        assert ec.coord.device == sess.device
        with pytest.raises(ValueError, match="workers"):
            sess.distributed(elastic=True)

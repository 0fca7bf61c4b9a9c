"""Port parity: the scheduler (srs_tpu_torch.scheduler against
srs_tpu.scheduler).

Each of the 16 scenarios of tests/test_scheduler.py runs on both packages
with the same inputs (fixed submit times, so priorities are equal too) and
returns what it observed: priorities, queue order, statuses, retry counts,
degradation fields, scaling targets, statistics counters, callbacks. The
two packages must observe the same, and the reference's own assertions
hold on the port. Task and agent ids are uuids and differ; they are not
compared. A checkpoint written by either package restores in the other.

The reference registers one agent per JAX device (8 virtual CPU devices,
tests/conftest.py); the port one per CUDA device, or per device of an
explicit list, which is how it runs here.
"""

import asyncio
import time

import pytest
import torch

import srs_tpu.scheduler.scheduler as ref_mod
import srs_tpu_torch.scheduler.scheduler as port_mod

T0 = 1_000_000.0
RESULT = {"output_path": "", "width": 1, "height": 1, "color_mode": "RGB"}


def run(coro):
    return asyncio.run(coro)


def _devices(mod):
    """What each package's attach_mesh_devices is called with here."""
    return None if mod is ref_mod else [torch.device("cpu")] * 8


def priority_formula(m, _tmp):
    p = {name: m.Task.calculate_priority(vip, roi, edge, t)
         for name, (vip, roi, edge, t) in {
             "normal": (m.VIPLevel.NORMAL, False, False, T0),
             "vip": (m.VIPLevel.ENTERPRISE, False, False, T0),
             "roi": (m.VIPLevel.NORMAL, True, False, T0),
             "edge": (m.VIPLevel.NORMAL, False, True, T0),
             "later": (m.VIPLevel.NORMAL, False, False, T0 + 1000)}.items()}
    assert p["vip"] < p["roi"] < p["edge"] < p["normal"] < p["later"]
    assert p["vip"] == p["normal"] - 4 * 10000
    return p


def priority_queue_ordering(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=0)
        tasks = [m.Task(vip_level=m.VIPLevel.NORMAL, submit_time=T0),
                 m.Task(vip_level=m.VIPLevel.ENTERPRISE, submit_time=T0 + 1),
                 m.Task(vip_level=m.VIPLevel.NORMAL, has_roi=True, submit_time=T0 + 2),
                 m.Task(vip_level=m.VIPLevel.NORMAL, has_edge_dependency=True,
                        submit_time=T0 + 3)]
        for t in tasks:
            await s.submit_task(t)
        order = []
        while (t := await s.get_next_task()) is not None:
            order.append(tasks.index(t))
        return order, [t.priority for t in tasks]

    order, prios = run(go())
    assert order[:3] == [1, 2, 3]
    return {"order": order, "priorities": prios}


def dispatch_and_collect(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=3)
        task = m.Task(target_resolution=(100, 100))
        await s.submit_task(task)
        n = await s._dispatch_tasks()
        status = task.status.name
        ok = await s.collect_result(
            task.task_id, {"output_path": "", "width": 100, "height": 100, "color_mode": "RGB"})
        agent = s._agents[task.assigned_agent]
        return {"dispatched": n, "status_after_dispatch": status, "ok": ok,
                "status": task.status.name, "processed": agent.processed_tasks,
                "agent_status": agent.status.name, "pending": agent.pending_tasks,
                "counters": s.get_statistics()["counters"]}

    out = run(go())
    assert out["dispatched"] == 1 and out["ok"] and out["status"] == "SUCCESS"
    assert out["counters"]["completed"] == 1
    return out


def result_validation(m, _tmp):
    s = m.AgentScheduler(initial_agents=1)
    task = m.Task(target_resolution=(1000, 1000))
    cases = [{"output_path": "", "width": 1040, "height": 1000, "color_mode": "RGB"},
             {"output_path": "", "width": 1100, "height": 1000, "color_mode": "RGB"},
             {"width": 1000}]
    out = [s._validate_result(r, task) for r in cases]
    assert out == [True, False, False]
    return out


def failure_retry_then_degradation(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=1)
        task = m.Task(scale_factor=4.0, max_retries=3, submit_time=T0)
        await s.submit_task(task)
        trail = []
        for i in range(4):
            await s.handle_failure(task, f"fail {i}")
            trail.append([task.status.name, task.retry_count, task.priority,
                          task.scale_factor, dict(task.tile_config), task.error_message])
        return trail, dict(s._stats, start_time=None), len(s._task_heap)

    trail, stats, depth = run(go())
    assert [t[0] for t in trail] == ["RETRYING"] * 3 + ["DEGRADED"]
    assert trail[-1][3] == pytest.approx(2.8)
    assert trail[-1][4] == {"tile_size": 256, "overlap": 16, "use_fallback_engine": True}
    assert stats["degraded"] == 1 and stats["retried"] == 3
    return {"trail": trail, "stats": stats, "heap": depth}


def degradation_scale_floor(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=1)
        task = m.Task(scale_factor=1.6, max_retries=0)
        await s.submit_task(task)
        await s.handle_failure(task, "x")
        return task.scale_factor, task.status.name

    out = run(go())
    assert out == (1.5, "DEGRADED")
    return out


def agent_weight_formula(m, _tmp):
    a = m.Agent(capacity=2)
    weights = [a.calculate_weight()]
    a.avg_processing_time = 1.0
    weights.append(a.calculate_weight())
    a.network_latency = 100.0
    weights.append(a.calculate_weight())
    a.degradation_level = 2
    weights.append(a.calculate_weight())
    a.degradation_level = 3
    assert weights == pytest.approx([120, 620, 710, 610])
    assert not a.is_available()
    return weights


def load_balancing(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=0)
        slow, fast = s._add_agent_sync(), s._add_agent_sync()
        slow.avg_processing_time, fast.avg_processing_time = 10.0, 0.5
        chosen = await s._select_agent()
        return chosen is fast, chosen.weight

    out = run(go())
    assert out[0]
    return out


def health_check(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=2)
        task = m.Task()
        await s.submit_task(task)
        await s._dispatch_tasks()
        agent = s._agents[task.assigned_agent]
        agent.last_heartbeat = time.time() - 100
        dead = await s._check_agent_health()
        return (dead == [agent.agent_id], agent.status.name, task.status.name,
                task.retry_count, agent.pending_tasks)

    out = run(go())
    assert out[:3] == (True, "OFFLINE", "RETRYING")
    return out


def dynamic_scaling(m, _tmp):
    async def go():
        s = m.AgentScheduler(max_agents=100, max_concurrent=60, initial_agents=5)
        sizes = [await s.scale_agents(d) for d in (5, 55, 120, 8)]
        return sizes, s._stats["scale_up_count"], s._stats["scale_down_count"]

    sizes, up, down = run(go())
    assert sizes[:3] == [5, 10, 30] and sizes[3] <= 30
    return {"sizes": sizes, "up": up, "down": down}


def checkpoint_roundtrip(m, tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=3, checkpoint_dir=str(tmp))
        done, processing, pending = m.Task(), m.Task(), m.Task()
        done.status = m.TaskStatus.SUCCESS
        for t in (done, processing, pending):
            await s.submit_task(t)
        processing.status = m.TaskStatus.PROCESSING
        path = s.save_checkpoint()
        s2 = m.AgentScheduler(initial_agents=0, checkpoint_dir=str(tmp))
        ok = s2.restore_checkpoint(path)
        names = {done.task_id: "done", processing.task_id: "processing",
                 pending.task_id: "pending"}
        statuses = {names[k]: t.status.name for k, t in s2._tasks.items()}
        queued = sorted(names[tid] for _, tid, _ in s2._task_heap)
        missing = s2.restore_checkpoint(str(tmp / "missing.json"))
        return ok, statuses, queued, len(s2._agents), missing

    ok, statuses, queued, agents, missing = run(go())
    assert ok and not missing and agents == 3
    assert statuses["processing"] == "RETRYING" and statuses["done"] == "SUCCESS"
    assert "processing" in queued
    return {"statuses": statuses, "queued": queued, "agents": agents}


def scheduler_loop(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=2)
        await s.start()
        task = m.Task()
        await s.submit_task(task)
        await asyncio.sleep(1.3)
        await s.stop()
        return task.status.name, s._loop_task is None

    out = run(go())
    assert out == ("PROCESSING", True)
    return out


def mesh_backed_agents(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=0)
        agents = s.attach_mesh_devices(_devices(m))
        await s.scale_agents(0)
        kept = sum(1 for a in s._agents.values() if a.device is not None)
        return len(agents), kept, s.get_statistics()["agents"], agents[0].capabilities

    n, kept, stats, caps = run(go())
    assert n == kept == 8 and stats["mesh_backed"]
    assert caps == ["cpu"]
    return {"agents": n, "kept": kept, "stats": stats}


def result_callbacks(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=1)
        seen = []
        s.add_result_callback(lambda t: seen.append(t.task_id))
        task = m.Task()
        await s.submit_task(task)
        await s._dispatch_tasks()
        await s.collect_result(task.task_id, RESULT)
        return seen == [task.task_id]

    assert run(go())
    return True


def task_serialization(m, _tmp):
    t = m.Task(vip_level=m.VIPLevel.GOLD, has_roi=True, target_resolution=(10, 20),
               submit_time=T0)
    d = t.to_dict()
    t2 = m.Task.from_dict(d)
    assert t2.vip_level == m.VIPLevel.GOLD and t2.target_resolution == (10, 20)
    assert t2.priority == t.priority
    return {k: v for k, v in d.items() if k != "task_id"}


def get_task_result(m, _tmp):
    async def go():
        s = m.AgentScheduler(initial_agents=1)
        task = m.Task()
        await s.submit_task(task)
        await s._dispatch_tasks()
        missing = await s.get_task_result("missing")
        await s.collect_result(task.task_id, RESULT)
        res = await s.get_task_result(task.task_id, timeout=1.0)
        return missing, res, s.get_task(task.task_id) is task

    missing, res, same = run(go())
    assert missing is None and res["width"] == 1 and same
    return res


SCENARIOS = [priority_formula, priority_queue_ordering, dispatch_and_collect,
             result_validation, failure_retry_then_degradation, degradation_scale_floor,
             agent_weight_formula, load_balancing, health_check, dynamic_scaling,
             checkpoint_roundtrip, scheduler_loop, mesh_backed_agents, result_callbacks,
             task_serialization, get_task_result]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    assert scenario(port_mod, tmp_path / "port") == scenario(ref_mod, tmp_path / "ref")


@pytest.mark.parametrize("writer,reader", [(ref_mod, port_mod), (port_mod, ref_mod)],
                         ids=["reference_to_port", "port_to_reference"])
def test_checkpoint_restores_in_the_other_package(writer, reader, tmp_path):
    """A checkpoint holds tasks in every state (vip, roi, a degraded one
    with its tile config) and agents; the other package restores the same
    tasks, queue, agents and counters."""

    async def fill(m):
        s = m.AgentScheduler(initial_agents=2, checkpoint_dir=str(tmp_path))
        tasks = [m.Task(vip_level=m.VIPLevel.PLATINUM, has_roi=True, submit_time=T0,
                        target_resolution=(640, 480), scale_factor=3.0),
                 m.Task(submit_time=T0 + 1), m.Task(submit_time=T0 + 2, max_retries=0)]
        for t in tasks:
            await s.submit_task(t)
        await s._dispatch_tasks()
        await s.collect_result(tasks[0].task_id, {**RESULT, "width": 640, "height": 480})
        await s.handle_failure(tasks[2], "oom")
        return s

    s = run(fill(writer))
    path = s.save_checkpoint()
    got = reader.AgentScheduler(initial_agents=0, checkpoint_dir=str(tmp_path))
    assert got.restore_checkpoint(path)

    def view(sched):
        return ({tid: {k: v for k, v in t.to_dict().items()}
                 for tid, t in sched._tasks.items()},
                sorted((p, tid) for p, tid, _ in sched._task_heap),
                {aid: a.to_dict()["degradation_level"] for aid, a in sched._agents.items()},
                {k: v for k, v in sched._stats.items() if k != "start_time"})

    again = writer.AgentScheduler(initial_agents=0, checkpoint_dir=str(tmp_path))
    assert again.restore_checkpoint(path)
    assert view(got) == view(again)
    statuses = sorted(t.status.name for t in got._tasks.values())
    assert statuses == ["DEGRADED", "RETRYING", "SUCCESS"]  # PROCESSING restores as RETRYING
    degraded = next(t for t in got._tasks.values() if t.status.name == "DEGRADED")
    assert degraded.tile_config == {"tile_size": 256, "overlap": 16, "use_fallback_engine": True}


def test_attach_mesh_devices_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mod.AgentScheduler(initial_agents=0).attach_mesh_devices()

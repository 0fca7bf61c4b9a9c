"""AgentScheduler: priority work queue, load balancing, failure ladder
(port of ``srs_tpu/scheduler/scheduler.py``, all of it).

`TaskStatus`/`AgentStatus`/`VIPLevel`, `Task` with the VIP/ROI/edge/FIFO
priority formula, `Agent` with the capacity/performance/latency weight
formula, and `AgentScheduler` with the 1 s control loop (health ->
autoscale -> dispatch), heap dispatch to the max-weight agent, result
validation, the retry-then-degrade failure ladder, queue-depth
autoscaling, JSON checkpoint/resume (PROCESSING -> RETRYING on restore;
the reference's format, so a checkpoint written by either package restores
in the other) and the statistics endpoint.

The scheduler is the host-side policy layer of the pipeline (ordering,
admission, retries, degradation, checkpointing); the tile compute runs
on the card. "Agents" default to logical workers; `attach_mesh_devices`
registers one agent per CUDA device (or per device of an explicit list),
in which case autoscaling never drops a device-backed agent.
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import json
import os
import time
import uuid
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import SchedulerConfig
from ..utils.device import resolve_device


class TaskStatus(Enum):
    """(reference: agent_scheduler.py:41-49)."""

    PENDING = "pending"
    PROCESSING = "processing"
    SUCCESS = "success"
    FAILED = "failed"
    RETRYING = "retrying"
    DEGRADED = "degraded"


class AgentStatus(Enum):
    """(reference: agent_scheduler.py:51-57)."""

    IDLE = "idle"
    BUSY = "busy"
    OFFLINE = "offline"
    DEGRADED = "degraded"


class VIPLevel(Enum):
    """(reference: agent_scheduler.py:59-65)."""

    NORMAL = 0
    SILVER = 1
    GOLD = 2
    PLATINUM = 3
    ENTERPRISE = 4


@dataclass(order=True)
class Task:
    """(reference: agent_scheduler.py:68-205)."""

    priority: float = field(default=0.0, compare=True)
    task_id: str = field(default_factory=lambda: str(uuid.uuid4()), compare=False)
    vip_level: VIPLevel = field(default=VIPLevel.NORMAL, compare=False)
    has_roi: bool = field(default=False, compare=False)
    has_edge_dependency: bool = field(default=False, compare=False)
    submit_time: float = field(default_factory=time.time, compare=False)
    status: TaskStatus = field(default=TaskStatus.PENDING, compare=False)
    retry_count: int = field(default=0, compare=False)
    max_retries: int = field(default=3, compare=False)
    input_path: str = field(default="", compare=False)
    output_path: str = field(default="", compare=False)
    scale_factor: float = field(default=2.0, compare=False)
    target_resolution: Tuple[int, int] = field(default_factory=lambda: (0, 0), compare=False)
    color_mode: str = field(default="RGB", compare=False)
    tile_config: Dict[str, Any] = field(default_factory=dict, compare=False)
    result_data: Optional[Dict[str, Any]] = field(default=None, compare=False)
    error_message: str = field(default="", compare=False)
    checkpoint_data: Dict[str, Any] = field(default_factory=dict, compare=False)
    assigned_agent: Optional[str] = field(default=None, compare=False)
    processing_start_time: Optional[float] = field(default=None, compare=False)
    processing_end_time: Optional[float] = field(default=None, compare=False)

    @classmethod
    def calculate_priority(
        cls,
        vip_level: VIPLevel,
        has_roi: bool,
        has_edge_dependency: bool,
        submit_time: float,
    ) -> float:
        """-VIP*10000 - ROI*1000 - edge*100 + t*0.001, lower wins
        (reference: agent_scheduler.py:131-173)."""
        priority = 0.0
        priority -= vip_level.value * 10000
        if has_roi:
            priority -= 1000
        if has_edge_dependency:
            priority -= 100
        priority += submit_time * 0.001
        return priority

    def __post_init__(self):
        if self.priority == 0.0:
            self.priority = self.calculate_priority(
                self.vip_level, self.has_roi, self.has_edge_dependency, self.submit_time
            )

    def to_dict(self) -> Dict[str, Any]:
        data = asdict(self)
        data["vip_level"] = self.vip_level.name
        data["status"] = self.status.name
        return data

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Task":
        data = dict(data)
        if isinstance(data.get("vip_level"), str):
            data["vip_level"] = VIPLevel[data["vip_level"]]
        if isinstance(data.get("status"), str):
            data["status"] = TaskStatus[data["status"]]
        if isinstance(data.get("target_resolution"), list):
            data["target_resolution"] = tuple(data["target_resolution"])
        return cls(**data)

    def get_processing_duration(self) -> Optional[float]:
        if self.processing_start_time is None:
            return None
        return (self.processing_end_time or time.time()) - self.processing_start_time


@dataclass
class Agent:
    """(reference: agent_scheduler.py:208-305). ``device`` (a
    ``torch.device``) marks agents backed by a device."""

    agent_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    status: AgentStatus = field(default=AgentStatus.IDLE)
    capacity: int = 1
    current_load: int = 0
    pending_tasks: List[str] = field(default_factory=list)
    processed_tasks: int = 0
    avg_processing_time: float = 0.0
    network_latency: float = 0.0
    weight: float = 1.0
    last_heartbeat: float = field(default_factory=time.time)
    capabilities: List[str] = field(default_factory=list)
    degradation_level: int = 0
    device: Optional[Any] = field(default=None, repr=False)

    def calculate_weight(self) -> float:
        """base 100 + free_capacity*10 + 1000/(avg_time+1) + latency bonus
        - degradation*50 (reference: agent_scheduler.py:242-276)."""
        weight = 100.0
        weight += max(0, self.capacity - len(self.pending_tasks)) * 10
        if self.avg_processing_time > 0:
            weight += 1000.0 / (self.avg_processing_time + 1)
        if self.network_latency > 0:
            weight += max(0, 100 - self.network_latency * 0.1)
        weight -= self.degradation_level * 50
        self.weight = weight
        return weight

    def is_available(self) -> bool:
        return (
            self.status in (AgentStatus.IDLE, AgentStatus.BUSY)
            and len(self.pending_tasks) < self.capacity
            and self.degradation_level < 3
        )

    def update_heartbeat(self) -> None:
        self.last_heartbeat = time.time()

    def check_health(self, timeout: float = 30.0) -> bool:
        return (time.time() - self.last_heartbeat) < timeout

    def to_dict(self) -> Dict[str, Any]:
        data = asdict(self)
        data["status"] = self.status.name
        data.pop("device", None)
        return data

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Agent":
        data = dict(data)
        if isinstance(data.get("status"), str):
            data["status"] = AgentStatus[data["status"]]
        data.pop("device", None)
        return cls(**data)


class AgentScheduler:
    """Priority scheduler with health checks, autoscaling and checkpoints."""

    QUEUE_DEPTH_LOW = 10
    QUEUE_DEPTH_HIGH = 50
    QUEUE_DEPTH_CRITICAL = 100
    SCALE_UP_THRESHOLD = 0.8
    SCALE_DOWN_THRESHOLD = 0.2
    MIN_AGENTS = 5
    MAX_AGENTS = 500
    HEARTBEAT_TIMEOUT = 30.0

    def __init__(
        self,
        max_agents: int = 100,
        max_concurrent: int = 60,
        checkpoint_dir: Optional[str] = None,
        config: Optional[SchedulerConfig] = None,
        initial_agents: Optional[int] = None,
    ):
        cfg = config or SchedulerConfig()
        self.config = cfg
        self.max_agents = max_agents if max_agents != 100 else cfg.max_agents
        self.max_concurrent = max_concurrent if max_concurrent != 60 else cfg.max_concurrent
        self.MIN_AGENTS = cfg.min_agents
        self.MAX_AGENTS = cfg.scale_max_agents
        self.HEARTBEAT_TIMEOUT = cfg.heartbeat_timeout
        self.checkpoint_dir = os.path.expanduser(checkpoint_dir or cfg.checkpoint_dir)

        self._task_heap: List[Tuple[float, str, Task]] = []
        self._tasks: Dict[str, Task] = {}
        self._agents: Dict[str, Agent] = {}
        self._queue_lock = asyncio.Lock()
        self._agent_lock = asyncio.Lock()
        self._result_callbacks: List[Callable[[Task], Any]] = []
        self._agent_failures: Dict[str, List[float]] = {}
        self._mesh_backed = False
        self._running = False
        self._loop_task: Optional[asyncio.Task] = None
        self._stats = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "retried": 0,
            "degraded": 0,
            "scale_up_count": 0,
            "scale_down_count": 0,
            "start_time": time.time(),
        }
        n0 = initial_agents if initial_agents is not None else self.MIN_AGENTS
        for _ in range(n0):
            self._add_agent_sync()

    # -- agent pool --------------------------------------------------------
    def _add_agent_sync(self, device: Any = None) -> Agent:
        agent = Agent(device=device)
        if device is not None:
            agent.capabilities = [device.type]
        self._agents[agent.agent_id] = agent
        return agent

    async def _add_agent(self) -> Agent:
        return self._add_agent_sync()

    async def _remove_idle_agents(self, count: int) -> int:
        removed = 0
        for aid in list(self._agents):
            if removed >= count:
                break
            a = self._agents[aid]
            if a.status == AgentStatus.IDLE and not a.pending_tasks and a.device is None:
                del self._agents[aid]
                removed += 1
        return removed

    def attach_mesh_devices(self, devices: Optional[List[Any]] = None) -> List[Agent]:
        """Register one agent per device: of ``devices`` (``torch.device``
        or its name) when given, else of every CUDA device torch sees
        (``torch.cuda.device_count()``), which raises without a card.
        Pins the pool: autoscale never drops a device-backed agent."""
        if devices:
            devices = [torch.device(d) for d in devices]
        else:
            resolve_device("cuda")  # raises without a card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        agents = [self._add_agent_sync(device=d) for d in devices]
        self._mesh_backed = True
        return agents

    # -- lifecycle (reference: agent_scheduler.py:395-431) -----------------
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop_task = asyncio.create_task(self._scheduler_loop())

    async def stop(self) -> None:
        self._running = False
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None

    async def _scheduler_loop(self, tick: float = 1.0) -> None:
        """health -> autoscale -> dispatch, every second."""
        while self._running:
            try:
                await self._check_agent_health()
                await self.scale_agents(len(self._task_heap))
                await self._dispatch_tasks()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - loop must survive
                pass
            await asyncio.sleep(tick)

    # -- health (reference: agent_scheduler.py:433-445) --------------------
    async def _check_agent_health(self) -> List[str]:
        dead = []
        async with self._agent_lock:
            for agent in self._agents.values():
                if agent.status != AgentStatus.OFFLINE and not agent.check_health(
                    self.HEARTBEAT_TIMEOUT
                ):
                    agent.status = AgentStatus.OFFLINE
                    dead.append(agent.agent_id)
        for aid in dead:
            agent = self._agents[aid]
            for tid in list(agent.pending_tasks):
                task = self._tasks.get(tid)
                if task is not None:
                    await self.handle_failure(task, f"agent {aid} offline")
            agent.pending_tasks.clear()
            agent.current_load = 0
        return dead

    # -- dispatch (reference: agent_scheduler.py:447-496) ------------------
    async def _dispatch_tasks(self) -> int:
        dispatched = 0
        while True:
            async with self._queue_lock:
                if not self._task_heap:
                    break
                processing = sum(
                    1 for t in self._tasks.values() if t.status == TaskStatus.PROCESSING
                )
                if processing >= self.max_concurrent:
                    break
                priority, tid, task = heapq.heappop(self._task_heap)
            agent = await self._select_agent()
            if agent is None:
                async with self._queue_lock:
                    heapq.heappush(self._task_heap, (priority, tid, task))
                break
            await self.assign_to_agent(task, agent)
            dispatched += 1
        return dispatched

    async def _select_agent(self) -> Optional[Agent]:
        async with self._agent_lock:
            best = None
            best_w = -1.0
            for agent in self._agents.values():
                if not agent.is_available():
                    continue
                w = agent.calculate_weight()
                if w > best_w:
                    best, best_w = agent, w
            return best

    # -- queue (reference: agent_scheduler.py:498-602) ---------------------
    async def submit_task(self, task: Task) -> str:
        async with self._queue_lock:
            self._tasks[task.task_id] = task
            heapq.heappush(self._task_heap, (task.priority, task.task_id, task))
            self._stats["submitted"] += 1
        return task.task_id

    async def get_next_task(self) -> Optional[Task]:
        async with self._queue_lock:
            if not self._task_heap:
                return None
            _, _, task = heapq.heappop(self._task_heap)
            return task

    async def assign_to_agent(self, task: Task, agent: Agent) -> None:
        async with self._agent_lock:
            task.assigned_agent = agent.agent_id
            task.status = TaskStatus.PROCESSING
            task.processing_start_time = time.time()
            agent.pending_tasks.append(task.task_id)
            agent.current_load = len(agent.pending_tasks)
            agent.status = (
                AgentStatus.BUSY if agent.current_load >= agent.capacity else AgentStatus.IDLE
            )

    # -- results (reference: agent_scheduler.py:604-742) -------------------
    def add_result_callback(self, cb: Callable[[Task], Any]) -> None:
        self._result_callbacks.append(cb)

    async def collect_result(self, task_id: str, result: Dict[str, Any]) -> bool:
        task = self._tasks.get(task_id)
        if task is None:
            return False
        if not self._validate_result(result, task):
            await self.handle_failure(task, "result validation failed")
            return False
        task.result_data = result
        task.status = TaskStatus.SUCCESS
        task.processing_end_time = time.time()
        self._stats["completed"] += 1
        agent = self._agents.get(task.assigned_agent or "")
        if agent is not None:
            if task.task_id in agent.pending_tasks:
                agent.pending_tasks.remove(task.task_id)
            agent.current_load = len(agent.pending_tasks)
            agent.processed_tasks += 1
            agent.status = AgentStatus.IDLE if agent.current_load == 0 else AgentStatus.BUSY
            dur = task.get_processing_duration() or 0.0
            # EMA 0.9/0.1 (reference: agent_scheduler.py:654-659)
            agent.avg_processing_time = (
                dur
                if agent.avg_processing_time == 0
                else 0.9 * agent.avg_processing_time + 0.1 * dur
            )
            agent.update_heartbeat()
        for cb in self._result_callbacks:
            try:
                out = cb(task)
                if asyncio.iscoroutine(out):
                    await out
            except Exception:  # noqa: BLE001 - callbacks must not break collection
                pass
        return True

    def _validate_result(self, result: Dict[str, Any], task: Task) -> bool:
        """Required fields, resolution +-5%, color-mode warn, file
        size/md5 (reference: agent_scheduler.py:676-742)."""
        for f in ("output_path", "width", "height", "color_mode"):
            if f not in result:
                return False
        if task.target_resolution != (0, 0):
            ew, eh = task.target_resolution
            aw, ah = result.get("width", 0), result.get("height", 0)
            if aw != ew or ah != eh:
                tol = 0.05
                if abs(aw - ew) / max(ew, 1) > tol or abs(ah - eh) / max(eh, 1) > tol:
                    return False
        out = result.get("output_path")
        if out and os.path.exists(out):
            if os.path.getsize(out) == 0:
                return False
            if "file_hash" in result:
                if self._calculate_file_hash(out) != result["file_hash"]:
                    return False
        return True

    @staticmethod
    def _calculate_file_hash(path: str) -> str:
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    # -- failure ladder (reference: agent_scheduler.py:752-887) ------------
    async def handle_failure(self, task: Task, error: str) -> None:
        task.error_message = error
        agent = self._agents.get(task.assigned_agent or "")
        if agent is not None:
            if task.task_id in agent.pending_tasks:
                agent.pending_tasks.remove(task.task_id)
            agent.current_load = len(agent.pending_tasks)
            # degrade agent after 3 failures within 5 minutes
            now = time.time()
            fails = self._agent_failures.setdefault(agent.agent_id, [])
            fails.append(now)
            self._agent_failures[agent.agent_id] = [t for t in fails if now - t < 300]
            if len(self._agent_failures[agent.agent_id]) >= 3:
                agent.degradation_level += 1
                agent.status = AgentStatus.DEGRADED
                self._agent_failures[agent.agent_id] = []

        if task.retry_count < task.max_retries:
            task.retry_count += 1
            task.status = TaskStatus.RETRYING
            task.assigned_agent = None
            # retry priority penalty +100*retry (reference: :810-815)
            task.priority += 100 * task.retry_count
            self._stats["retried"] += 1
            async with self._queue_lock:
                heapq.heappush(self._task_heap, (task.priority, task.task_id, task))
        else:
            self._apply_degradation(task)

    def _apply_degradation(self, task: Task) -> None:
        """scale x0.7 floor 1.5, tile 256 / overlap 16, fallback engine,
        +500 priority (reference: agent_scheduler.py:831-887)."""
        task.status = TaskStatus.DEGRADED
        task.scale_factor = max(1.5, task.scale_factor * 0.7)
        task.tile_config["tile_size"] = 256
        task.tile_config["overlap"] = 16
        task.tile_config["use_fallback_engine"] = True
        task.priority += 500
        task.retry_count = 0
        self._stats["degraded"] += 1
        heapq.heappush(self._task_heap, (task.priority, task.task_id, task))

    # -- autoscale (reference: agent_scheduler.py:889-959) -----------------
    async def scale_agents(self, queue_depth: int) -> int:
        async with self._agent_lock:
            current = len(self._agents)
            target = current
            usage = queue_depth / max(self.max_concurrent, 1)
            if usage > self.SCALE_UP_THRESHOLD and queue_depth >= self.QUEUE_DEPTH_HIGH:
                inc = 20 if queue_depth >= self.QUEUE_DEPTH_CRITICAL else 5
                target = min(current + inc, self.MAX_AGENTS, self.max_agents)
                if target > current:
                    self._stats["scale_up_count"] += 1
            elif usage < self.SCALE_DOWN_THRESHOLD and queue_depth < self.QUEUE_DEPTH_LOW:
                idle = sum(1 for a in self._agents.values() if a.status == AgentStatus.IDLE)
                if idle > self.MIN_AGENTS:
                    target = max(current - 3, self.MIN_AGENTS)
                    if target < current:
                        self._stats["scale_down_count"] += 1
            if self._mesh_backed:
                # physical pool: logical growth allowed, never drop devices
                devices = sum(1 for a in self._agents.values() if a.device is not None)
                target = max(target, devices)
            if target > current:
                for _ in range(target - current):
                    self._add_agent_sync()
            elif target < current:
                await self._remove_idle_agents(current - target)
            return len(self._agents)

    # -- checkpoint (reference: agent_scheduler.py:1076-1187) --------------
    def save_checkpoint(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.checkpoint_dir, "scheduler_checkpoint.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "timestamp": time.time(),
            "tasks": [t.to_dict() for t in self._tasks.values()],
            "agents": [a.to_dict() for a in self._agents.values()],
            "stats": self._stats,
            "max_agents": self.max_agents,
            "max_concurrent": self.max_concurrent,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def restore_checkpoint(self, path: Optional[str] = None) -> bool:
        path = path or os.path.join(self.checkpoint_dir, "scheduler_checkpoint.json")
        if not os.path.exists(path):
            return False
        with open(path) as f:
            payload = json.load(f)
        self._tasks.clear()
        self._task_heap.clear()
        self._agents.clear()
        for td in payload.get("tasks", []):
            task = Task.from_dict(td)
            # interrupted work becomes retryable (reference: :1146-1149)
            if task.status == TaskStatus.PROCESSING:
                task.status = TaskStatus.RETRYING
                task.assigned_agent = None
            self._tasks[task.task_id] = task
            if task.status in (TaskStatus.PENDING, TaskStatus.RETRYING, TaskStatus.DEGRADED):
                heapq.heappush(self._task_heap, (task.priority, task.task_id, task))
        for ad in payload.get("agents", []):
            agent = Agent.from_dict(ad)
            agent.pending_tasks = []
            agent.current_load = 0
            if agent.status == AgentStatus.BUSY:
                agent.status = AgentStatus.IDLE
            agent.update_heartbeat()
            self._agents[agent.agent_id] = agent
        self._stats.update(payload.get("stats", {}))
        return True

    # -- result access (reference docstring API, agent_scheduler.py:325) ---
    async def get_task_result(
        self, task_id: str, timeout: float = 0.0, poll: float = 0.05
    ) -> Optional[Dict[str, Any]]:
        """Result payload for a task; with ``timeout`` > 0, waits for a
        terminal state."""
        deadline = time.time() + timeout
        while True:
            task = self._tasks.get(task_id)
            if task is None:
                return None
            if task.status == TaskStatus.SUCCESS:
                return task.result_data
            if task.status == TaskStatus.FAILED:
                return None
            if timeout <= 0 or time.time() >= deadline:
                return task.result_data
            await asyncio.sleep(poll)

    def get_task(self, task_id: str) -> Optional[Task]:
        return self._tasks.get(task_id)

    # -- stats (reference: agent_scheduler.py:1189-1230) -------------------
    def get_statistics(self) -> Dict[str, Any]:
        status_counts: Dict[str, int] = {}
        for t in self._tasks.values():
            status_counts[t.status.value] = status_counts.get(t.status.value, 0) + 1
        online = [a for a in self._agents.values() if a.status != AgentStatus.OFFLINE]
        return {
            "agents": {
                "total": len(self._agents),
                "online": len(online),
                "idle": sum(1 for a in online if a.status == AgentStatus.IDLE),
                "busy": sum(1 for a in online if a.status == AgentStatus.BUSY),
                "degraded": sum(1 for a in online if a.status == AgentStatus.DEGRADED),
                "mesh_backed": self._mesh_backed,
            },
            "queue": {
                "depth": len(self._task_heap),
                "max_concurrent": self.max_concurrent,
            },
            "tasks": {"total": len(self._tasks), **status_counts},
            "scaling": {
                "scale_up_count": self._stats["scale_up_count"],
                "scale_down_count": self._stats["scale_down_count"],
            },
            "counters": {
                k: self._stats[k]
                for k in ("submitted", "completed", "failed", "retried", "degraded")
            },
            "uptime": time.time() - self._stats["start_time"],
        }



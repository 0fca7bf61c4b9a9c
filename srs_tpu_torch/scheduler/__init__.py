"""The job scheduler (port of ``srs_tpu.scheduler``)."""

from .scheduler import Agent, AgentScheduler, AgentStatus, Task, TaskStatus, VIPLevel

__all__ = ["AgentScheduler", "Agent", "Task", "TaskStatus", "AgentStatus", "VIPLevel"]

from .scheduler import IndexScheduler
from .tasks import Task, TaskStatus, TaskType

__all__ = ["IndexScheduler", "Task", "TaskStatus", "TaskType"]

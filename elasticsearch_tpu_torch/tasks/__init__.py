from elasticsearch_tpu_torch.tasks.task_manager import (
    Task, TaskCancelledError, TaskManager, action_family, activate,
    current_task,
)

__all__ = ["Task", "TaskCancelledError", "TaskManager", "action_family",
           "activate", "current_task"]

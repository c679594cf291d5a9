from .agent import Agent
from .exec import Controller, Executor, do_task
from .procexec import ProcessController, ProcessExecutor
from .worker import TaskManager, Worker

__all__ = ["Agent", "Controller", "Executor", "ProcessController",
           "ProcessExecutor", "TaskManager", "Worker", "do_task"]

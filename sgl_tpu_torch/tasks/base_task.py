"""Task base class (counterpart of ``sgl_tpu/tasks/base_task.py``)."""


class BaseTask:
    def __init__(self):
        pass

    def _execute(self):
        raise NotImplementedError

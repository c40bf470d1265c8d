"""Search base class — counterpart of ``sgl_tpu/search/base_search.py``."""


class BaseSearch:
    def __init__(self):
        pass

    def _execute(self):
        raise NotImplementedError

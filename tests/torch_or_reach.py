"""OR reachability written against ``repro_torch`` alone: a module of its
own, so that the worker and mesh-rank processes the tests spawn can unpickle
the program without importing JAX."""

import torch

from repro_torch.core.api import OR, VertexProgram


class Reach(VertexProgram):
    """Vertices reachable from ``source``: a float32 0/1 flag, sent along
    every out-edge by a newly reached vertex and combined with OR. It has no
    ``msg_kind``, so it runs on the torch backend."""

    combiner = OR

    def __init__(self, source: int):
        self.source = int(source)

    def init(self, ctx):
        flag = (ctx.new_ids == self.source).to(torch.float32)
        return flag, flag > 0

    def message(self, value, degree, weight, step):
        return value

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        got = has_msg & (msg > 0) & (value == 0)
        return torch.where(got, 1.0, value), got

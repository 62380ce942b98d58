from . import introspect, ir, prim, shapes, vfunc
from .introspect import describe, graph_stats
from .ir import TOp
from .shapes import Shape, ShapeError, Stack

from . import ir, prim, shapes, vfunc
from .ir import TOp
from .shapes import Shape, ShapeError, Stack

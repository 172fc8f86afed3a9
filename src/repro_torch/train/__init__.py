from .steps import Cell, build_cell

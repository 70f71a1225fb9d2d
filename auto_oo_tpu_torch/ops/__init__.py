from . import fermion

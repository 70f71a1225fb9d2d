from .newton_raphson import NewtonStep
from .misc import get_formal_geo
from .checkpoint import save_state, load_state, resume
from .observe import Monitor

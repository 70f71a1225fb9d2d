from .newton_raphson import NewtonStep
from .misc import get_formal_geo

from . import bdim
from .bdim import BDIMConfig, simulate_flow, simulate_flow_batch
from .nbody import DT, HEIGHT, RADIUS, WIDTH, eval_simu, generate_initial_states, simulate

__all__ = ["BDIMConfig", "DT", "HEIGHT", "RADIUS", "WIDTH", "bdim", "eval_simu",
           "generate_initial_states", "simulate", "simulate_flow", "simulate_flow_batch"]

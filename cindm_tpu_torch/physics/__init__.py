from .nbody import DT, HEIGHT, RADIUS, WIDTH, eval_simu, generate_initial_states, simulate

__all__ = ["DT", "HEIGHT", "RADIUS", "WIDTH", "eval_simu", "generate_initial_states", "simulate"]

from .diffusion import (
    ModelPrediction,
    Posterior,
    ddim_times,
    extract,
    model_prediction_from_output,
    predict_noise_from_start,
    predict_start_from_noise,
    predict_start_from_v,
    predict_v,
    q_posterior,
    q_sample,
)
from .schedules import DiffusionSchedule, make_schedule

__all__ = [
    "DiffusionSchedule",
    "ModelPrediction",
    "Posterior",
    "ddim_times",
    "extract",
    "make_schedule",
    "model_prediction_from_output",
    "predict_noise_from_start",
    "predict_start_from_noise",
    "predict_start_from_v",
    "predict_v",
    "q_posterior",
    "q_sample",
]

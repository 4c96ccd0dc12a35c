"""Datasets and τ_x-aware samplers."""
from . import pipeline, tasks
from .pipeline import dataset_sampler, generator_sampler, lm_sampler

__all__ = ["tasks", "pipeline", "dataset_sampler", "generator_sampler",
           "lm_sampler"]

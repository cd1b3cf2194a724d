"""Experiments layer, as far as the port's paths reach: the landing criteria,
the campaign scenario, the initial-condition sampler, the touchdown
classifier, the episode loop, the campaign and its statistics, and the
Wilson interval of ``monte_carlo``."""

from .monte_carlo import (
    CONSTRAINT_VIOLATION,
    CRASH,
    DIVERGENCE,
    FUEL_EXHAUSTED,
    OUTCOME_NAMES,
    RUNNING,
    SUCCESS,
    TIMEOUT,
    LandingCriteria,
    SimulationConfig,
    campaign_statistics,
    classify_touchdown,
    run_campaign,
    run_episode,
    sample_initial_conditions,
    wilson_interval,
)

__all__ = ["CONSTRAINT_VIOLATION", "CRASH", "DIVERGENCE", "FUEL_EXHAUSTED", "OUTCOME_NAMES",
           "RUNNING", "SUCCESS", "TIMEOUT", "LandingCriteria", "SimulationConfig",
           "campaign_statistics", "classify_touchdown", "run_campaign", "run_episode",
           "sample_initial_conditions", "wilson_interval"]

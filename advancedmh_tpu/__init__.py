"""advancedmh_tpu — a many-chain Metropolis-Hastings inference framework.

A from-scratch JAX/XLA/Pallas framework covering the full capability surface
of TuringLang/AdvancedMH.jl (v0.8.8), re-architected for accelerators:
samplers are pure ``(key, state) → (state, info)`` kernels composed by
``lax.scan`` over steps, ``vmap`` over thousands of chains per device, and
``shard_map`` over a ``chains`` device-mesh axis.

Public surface ≙ the reference exports (src/AdvancedMH.jl:15-30).
"""

from .distributions import (
    Distribution,
    Normal,
    LogNormal,
    Uniform,
    Exponential,
    Laplace,
    Cauchy,
    StudentT,
    TDist,
    Gamma,
    InverseGamma,
    Beta,
    MvNormal,
    Bernoulli,
    Poisson,
    Binomial,
    Geometric,
    Categorical,
    DiscreteUniform,
)
from .models import (
    DensityModel,
    CapabilityOrder,
    as_model,
    logdensity,
    logdensity_and_gradient,
    guarded_logdensity,
)
from .proposals import (
    Proposal,
    StaticProposal,
    RandomWalkProposal,
    SymmetricStaticProposal,
    SymmetricRandomWalkProposal,
    propose,
    propose_initial,
    q,
    logratio_proposal_density,
)
from .samplers import (
    MetropolisHastings,
    StaticMH,
    RWMH,
    MALA,
    RobustAdaptiveMetropolis,
    RobustAdaptiveMetropolisState,
    Ensemble,
    DRAM,
    PreconditionedCrankNicolson,
    DelayedRejection,
    StretchProposal,
    WalkProposal,
    ReplicaExchange,
    swap_rates,
    tune_betas,
    AdaptiveMetropolis,
    AdaptiveMetropolisState,
    Barker,
    HamiltonianMC,
    AdaptiveHMC,
    AdaptiveHMCState,
    ChEESHMC,
    ChEESHMCState,
    MEADS,
    MEADSState,
    EllipticalSlice,
    MultipleTryMetropolis,
    SliceSampler,
    DifferentialEvolution,
    StepSizeAdaptation,
    optimal_rwmh_accept,
    Transition,
    GradientTransition,
    getparams,
    setparams,
)
from .runtime import (
    log_evidence,
    log_evidence_ais,
    smc_sample,
    svgd_sample,
    power_ladder,
    sample,
    sample_chunked,
    ChunkInfo,
    Schedule,
    SamplingResult,
    MCMCSerial,
    MCMCThreads,
    MCMCDistributed,
    save_state,
    load_state,
)
from .output import Chains, StructArray, chainscat
from .diagnostics import (ess, ess_bulk, ess_tail, integrated_autocorr_time,
                          mcse, rhat, rhat_nested, rhat_rank)
from .parallel import make_mesh, chain_sharding

__version__ = "0.1.0"

__all__ = [
    # distributions
    "Distribution", "Normal", "LogNormal", "Uniform", "Exponential", "Laplace",
    "Cauchy", "StudentT", "TDist", "Gamma", "InverseGamma", "Beta", "MvNormal",
    "Bernoulli", "Poisson", "Binomial", "Geometric", "Categorical",
    "DiscreteUniform",
    # models
    "DensityModel", "CapabilityOrder", "as_model", "logdensity",
    "logdensity_and_gradient", "guarded_logdensity",
    # proposals
    "Proposal", "StaticProposal", "RandomWalkProposal",
    "SymmetricStaticProposal", "SymmetricRandomWalkProposal",
    "propose", "propose_initial", "q", "logratio_proposal_density",
    # samplers
    "MetropolisHastings", "StaticMH", "RWMH", "MALA",
    "RobustAdaptiveMetropolis", "RobustAdaptiveMetropolisState",
    "DRAM", "DelayedRejection", "Ensemble", "PreconditionedCrankNicolson", "StretchProposal", "WalkProposal",
    "ReplicaExchange",
    "swap_rates", "tune_betas",
    "AdaptiveMetropolis", "AdaptiveMetropolisState", "Barker", "HamiltonianMC",
    "AdaptiveHMC", "AdaptiveHMCState", "ChEESHMC", "ChEESHMCState",
    "MEADS", "MEADSState",
    "EllipticalSlice", "MultipleTryMetropolis", "SliceSampler",
    "DifferentialEvolution", "StepSizeAdaptation", "optimal_rwmh_accept",
    "Transition", "GradientTransition",
    "getparams", "setparams",
    # runtime
    "sample", "sample_chunked", "ChunkInfo", "log_evidence", "log_evidence_ais", "smc_sample", "svgd_sample", "power_ladder", "Schedule", "SamplingResult",
    "MCMCSerial", "MCMCThreads", "MCMCDistributed",
    "save_state", "load_state",
    # output / diagnostics
    "Chains", "StructArray", "chainscat", "ess", "ess_bulk", "ess_tail",
    "integrated_autocorr_time",
    "rhat", "rhat_nested", "rhat_rank", "mcse",
    # parallel
    "make_mesh", "chain_sharding",
]

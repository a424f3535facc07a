"""Host-side analysis toolkit: featurization, TICA, clustering, MSMs, metrics
(port of ``mdgen_tpu/analysis``, with the same exports).

Torsion featurization -> TICA -> k-means -> MSM -> PCCA+ coarse-graining ->
discrete transition-path math, on numpy arrays; the featurizer runs the
port's geometry in torch on the CPU.
"""
from .featurize import featurize_torsions  # noqa: F401
from .msm import (  # noqa: F401
    KMeans,
    MarkovStateModel,
    TICA,
    estimate_markov_model,
    get_state_probs,
    get_tp_likelihood,
    map_to_active,
    pcca_assignments,
    reference_replica_metrics,
    reference_tps_metrics,
    sample_tp,
)
from .metrics import (  # noqa: F401
    acovf,
    autocorrelation,
    hist_jsd,
    hist_jsd_2d,
    jensen_shannon,
    torsion_decorrelation_curve,
)
from .reference_msm import (  # noqa: F401
    build_reference_msm,
    highest_flux_states,
    load_msm_cache,
    load_or_build_msm,
    lowest_flux_states,
)

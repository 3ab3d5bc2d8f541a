"""Interpretation (counterpart of vlsa_tpu/interpret/): exact Shapley
values over the prognostic priors, the decoupled text-image similarity,
cohort attribution, reloading a trained run, and plots.  The plots
(`visualization`, matplotlib and scipy) are imported on their own, so
nothing else here needs matplotlib."""
from .shapley import batched_shapley, evaluate_prototype_shap_imp, shapley_values  # noqa: F401
from .similarity import (  # noqa: F401
    calc_abmil_text_img_similarity,
    calc_text_img_similarity,
)
from .loader import get_model_cfg, load_vlsa_from_run  # noqa: F401
from .cohort import interpret_cohort  # noqa: F401

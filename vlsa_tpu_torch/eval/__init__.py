"""The survival evaluator (counterpart of vlsa_tpu/eval): Kaplan-Meier,
C-index, IPCW Brier and IBS, MAE, D-calibration, Breslow, the SurvivalEVAL
facade and the task evaluators, and the classification evaluators
(clf_metrics: scikit-learn's metrics in numpy)."""
from .km import KaplanMeier, KaplanMeierArea  # noqa: F401
from .curves import (  # noqa: F401
    predict_mean_survival_time,
    predict_median_survival_time,
    predict_prob_from_curve,
    predict_multi_probs_from_curve,
)
from .concordance import (  # noqa: F401
    NoComparablePairException,
    concordance,
    concordance_index,
    concordance_index_censored,
)
from .brier import single_brier_score, brier_multiple_points  # noqa: F401
from .mean_error import mean_error  # noqa: F401
from .d_calibration import d_calibration  # noqa: F401
from .breslow import BreslowEstimator  # noqa: F401
from .survival_evaluator import SurvivalEvaluator  # noqa: F401
from .evaluators import (  # noqa: F401
    load_evaluator,
    NLLSurvEvaluator,
    CoxSurvEvaluator,
    RegSurvEvaluator,
)
from .clf_metrics import BinClfEvaluator, MultiClfEvaluator  # noqa: F401

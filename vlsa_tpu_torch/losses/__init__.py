"""Survival losses (counterpart of vlsa_tpu/losses for the sa/vlsa tasks)."""
from .registry import load_loss  # noqa: F401
from .surv import (mse_loss, rank_loss, recon_loss, surv_ifmle, surv_mle,  # noqa: F401
                   surv_ple)
from .surv_ext import (cdf_loss, convert_survival_label, sup_con_loss,  # noqa: F401
                       surv_emd, surv_t2i)

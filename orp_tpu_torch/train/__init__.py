"""The backward walk (Adam and Gauss-Newton; host loop or fused), its result types, out-of-sample replay and the Bermudan LSM pricers."""

from orp_tpu_torch.train.backward import BackwardConfig, BackwardResult, backward_induction
from orp_tpu_torch.train.fit import FitConfig, fit_core, reference_lr_schedule
from orp_tpu_torch.train.gn import GNConfig, GNPinballConfig, fit_gn, fit_gn_pinball, gram_cond
from orp_tpu_torch.train.lsm import bermudan_lsm, bermudan_lsm_heston
from orp_tpu_torch.train.replay import replay_walk

__all__ = ["BackwardConfig", "BackwardResult", "FitConfig", "GNConfig", "GNPinballConfig",
           "backward_induction", "bermudan_lsm", "bermudan_lsm_heston", "fit_core", "fit_gn",
           "fit_gn_pinball", "gram_cond", "reference_lr_schedule", "replay_walk"]

"""The port's samplers: Algorithm 1 (the online APF), Algorithm 3 (the
conditional SMC), Algorithm 2 (the Gibbs loop) and the classic-PGAS
baseline."""

from bipk_tpu_torch.algorithms.apf import APFResult, build_apf
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.algorithms.gibbs import GibbsResult, build_gibbs
from bipk_tpu_torch.algorithms.pgas import PGASResult, build_pgas, build_pgas_csmc

__all__ = ["APFResult", "GibbsResult", "PGASResult", "build_apf", "build_csmc", "build_gibbs",
           "build_pgas", "build_pgas_csmc"]

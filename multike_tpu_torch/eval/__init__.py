from multike_tpu_torch.eval.evaluation import valid, test, early_stop  # noqa: F401
from multike_tpu_torch.eval.alignment import greedy_alignment, stable_alignment  # noqa: F401
from multike_tpu_torch.eval.similarity import sim, csls_sim  # noqa: F401

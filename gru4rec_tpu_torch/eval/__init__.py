from gru4rec_tpu_torch.eval.evaluation import (evaluate, evaluate_gpu, evaluate_sessions,
                                               evaluate_sessions_batch)

__all__ = ["evaluate", "evaluate_gpu", "evaluate_sessions", "evaluate_sessions_batch"]

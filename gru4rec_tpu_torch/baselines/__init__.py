from gru4rec_tpu_torch.baselines.baselines import BPR, ItemKNN, Pop, RandomPred, SessionPop

__all__ = ["RandomPred", "Pop", "SessionPop", "ItemKNN", "BPR"]

from torchrec_tpu_torch.optim.adagrad import Adagrad, adagrad

__all__ = ["Adagrad", "adagrad"]

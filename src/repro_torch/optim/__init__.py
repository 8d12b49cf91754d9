from repro_torch.optim.optimizer import Optimizer, make_optimizer, cosine_schedule  # noqa: F401

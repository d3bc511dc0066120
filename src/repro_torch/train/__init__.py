"""The port's training side on one device (``repro.train``): the train
step (``train.steps``) and the fault-tolerant loop (``train.loop``)."""
from repro_torch.train.steps import make_train_step  # noqa: F401

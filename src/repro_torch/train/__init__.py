"""Training (``repro.train``): the train and eval steps, the train state
and the fault-tolerant loop, on one card.  The reference's sharding
specs (``param_specs``, ``state_specs``) are mesh layouts, ROADMAP
Queue 1 A4."""
from .loop import LoopConfig, StragglerMonitor, run
from .steps import abstract_state, init_state, loss_and_grads, \
    make_eval_step, make_train_step

__all__ = ["LoopConfig", "StragglerMonitor", "abstract_state", "init_state",
           "loss_and_grads", "make_eval_step", "make_train_step", "run"]

"""Training (``repro.train``): the train and eval steps, the train state
and the fault-tolerant loop, on one card or sharded over a process mesh
(``make_train_step(..., ctx=)``), and the train state's sharding specs
(``param_specs``, ``state_specs``) with the blocks a rank holds
(``shard_state``, ``shard_batch``)."""
from .loop import LoopConfig, StragglerMonitor, run
from .steps import abstract_state, batch_specs, init_state, \
    loss_and_grads, make_eval_step, make_train_step, opt_state_specs, \
    param_spec, param_specs, shard_batch, shard_state, state_specs

__all__ = ["LoopConfig", "StragglerMonitor", "abstract_state", "batch_specs",
           "init_state", "loss_and_grads", "make_eval_step",
           "make_train_step", "opt_state_specs", "param_spec", "param_specs",
           "run", "shard_batch", "shard_state", "state_specs"]

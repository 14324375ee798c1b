from .generate import greedy_generate_seq2seq  # noqa: F401
from .trainer import (  # noqa: F401
    ShardedTrainer,
    lm_loss,
    make_distill_loss,
    make_eval_step,
    make_mixed_precision_loss,
    make_moe_loss,
    make_train_scan,
    make_train_step,
)

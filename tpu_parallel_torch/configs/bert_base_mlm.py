"""BERT-base masked-LM pretraining (the bidirectional encoder family): the
port of ``configs/bert_base_mlm.py`` (its values; one device here)."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=0,
        model="bert_base",
        # encoders run flash attention in its non-causal chunk form; remat
        # with the attention residuals saved (the kernel's outputs count as
        # "attn")
        model_overrides=model_overrides(attn_impl="flash", remat_policy="proj_attn"),
        objective="mlm",
        mlm_mask_rate=0.15,
        mesh=dict(data=-1, model=1, pipe=1, seq=1),
        global_batch_size=64,
        num_minibatches=1,
        steps=100,
        optimizer="adamw",
        lr_schedule="cosine",
        ema_decay=0.0,
        learning_rate=1e-4,
        warmup_steps=20,
        weight_decay=0.01,
        grad_clip=1.0,
        seed=0,
        log_every=10,
        donate=True,
        checkpoint_dir="",
        checkpoint_every=100,
        data_path="",
        data_format="flat",
        eos_id=50256,
        eval_steps=0,
        eval_every=0,
        keep_best=False,
    )

"""GPT-2 125M on a real tokenized corpus with a held-out eval split: the
port of ``configs/gpt2_125m_corpus.py``.

Byte-level tokens (``scripts/prepare_data.py --tokenizer bytes`` writes the
flat uint16 ``.bin`` this reads), trained through ``Trainer.fit`` with
periodic held-out evaluation and best-checkpoint keeping.  The model is the
unmodified ``gpt2_125m`` (vocab 50304; byte ids occupy the first 256 rows).

    python -m tpu_parallel_torch.train --config=gpt2_125m_corpus \\
        --config.data_path=corpus.bin --config.checkpoint_dir=/tmp/ckpt
"""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        model="gpt2_125m",
        model_overrides=model_overrides(
            dropout_rate=0.0,
            attn_impl="flash",
            remat_policy="proj_attn",
            scan_layers=False,
        ),
        mesh=dict(data=-1, model=1, pipe=1, seq=1),
        global_batch_size=32,
        num_minibatches=2,
        steps=2000,
        optimizer="adamw",
        lr_schedule="cosine",
        ema_decay=0.0,
        learning_rate=3e-4,
        warmup_steps=100,
        weight_decay=0.1,
        grad_clip=1.0,
        seed=0,
        log_every=100,
        donate=True,
        checkpoint_dir="",
        checkpoint_every=400,
        data_path="",
        data_format="flat",
        eos_id=50256,
        # held-out evaluation: last 10% of windows never trained on
        eval_steps=20,
        eval_every=200,
        eval_fraction=0.1,
        keep_best=True,
    )

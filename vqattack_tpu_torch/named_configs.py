"""The reference's sacred named-config surface as plain data.

Port of ``vqattack_tpu/named_configs.py`` (the port imports nothing of the
JAX package, so it keeps its own copy).  The VLMo pipeline of the reference
is configured by one base ``@ex.config`` (``VLMO_VQAttack/vlmo/config.py:21-91``)
and ~25 ``@ex.named_config`` presets composed left to right on the command
line (``python run.py with task_finetune_vqa_base_image480``).  The key
space is kept verbatim as dict deltas, and :func:`vlmo_config_from_named`
bridges a resolved dict into the port's :class:`~vqattack_tpu_torch.config.VLMoConfig`,
:func:`train_settings_from_named` into the training CLI's settings.
"""

from __future__ import annotations

from typing import Dict


def loss_names(d: Dict[str, float]) -> Dict[str, float]:
    """``vlmo/config.py::_loss_names:6-17``: zero-filled 7-task weights."""
    ret = {
        "itm": 0,
        "itc": 0,
        "mlm": 0,
        "textmlm": 0,
        "vqa": 0,
        "nlvr2": 0,
        "irtr": 0,
    }
    ret.update(d)
    return ret


# the base ``@ex.config`` (``vlmo/config.py:21-91``), key-for-key
VLMO_BASE: Dict[str, object] = dict(
    exp_name="vlmo",
    seed=1,
    datasets=["coco", "vg", "sbu", "gcc"],
    loss_names=loss_names({"itm": 1, "itc": 1, "mlm": 1}),
    batch_size=1024,  # desired global batch; grads accumulate when smaller
    # image settings
    train_transform_keys=["square_transform_randaug"],
    val_transform_keys=["square_transform"],
    image_size=224,
    draw_false_image=0,
    image_only=False,
    text_only=False,
    # text settings
    vqav2_label_size=3129,
    max_text_len=40,
    max_text_len_of_initckpt=196,
    tokenizer="bert-base-uncased",
    vocab_size=30522,
    whole_word_masking=False,
    mlm_prob=0.15,
    draw_false_text=0,
    # transformer settings
    model_arch="vlmo_base_patch16",
    drop_path_rate=0.1,
    # optimizer settings
    optim_type="adamw",
    learning_rate=1e-4,
    weight_decay=0.01,
    decay_power=1,
    max_epoch=100,
    max_steps=200000,
    warmup_steps=0.1,
    end_lr=0,
    lr_mult=1,
    # downstream settings
    get_recall_metric=False,
    get_recall_rerank_metric=False,
    k_test=32,
    # trainer settings
    resume_from=None,
    fast_dev_run=False,
    val_check_interval=1.0,
    test_only=False,
    use_sharded_training=False,
    resume_during_training=False,
    # environment-varying params (placeholders as in the reference)
    data_root="set the VQA_arrow path",
    log_dir="result",
    per_gpu_batchsize=1,
    num_gpus=1,
    num_nodes=1,
    pretrain_path="set the pretrain model path",
    load_path="set the vqa model path",
    num_workers=8,
    precision=32,
)


def _nlvr2(arch: str, lr: float, **extra) -> Dict[str, object]:
    d = dict(
        datasets=["nlvr2"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=loss_names({"nlvr2": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        learning_rate=lr,
        val_transform_keys=["square_transform"],
        use_sharded_training=False,
        model_arch=arch,
    )
    d.update(extra)
    return d


def _vqa480(arch: str, lr: float) -> Dict[str, object]:
    return dict(
        datasets=["vqa"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=loss_names({"vqa": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        learning_rate=lr,
        drop_path_rate=0.15,
        val_transform_keys=["square_transform"],
        lr_mult=20,
        image_size=480,
        use_sharded_training=False,
        model_arch=arch,
    )


def _irtr(dataset: str, arch: str, lr: float, drop_path: float,
          max_steps: int, warmup: int, **extra) -> Dict[str, object]:
    d = dict(
        datasets=[dataset],
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        loss_names=loss_names({"irtr": 1.0}),
        batch_size=3072,
        max_epoch=50,
        max_steps=max_steps,
        warmup_steps=warmup,
        get_recall_metric=True,
        learning_rate=lr,
        drop_path_rate=drop_path,
        use_sharded_training=False,
        model_arch=arch,
    )
    d.update(extra)
    return d


def _textmlm(arch: str) -> Dict[str, object]:
    return dict(
        datasets=["wikibk"],
        loss_names=loss_names({"textmlm": 1}),
        batch_size=1024,
        max_text_len=196,
        learning_rate=2e-4,
        whole_word_masking=True,
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        model_arch=arch,
    )


# the ``@ex.named_config`` presets (``vlmo/config.py:96-507``), exp_name
# included so run lines and log dirs match the reference's
NAMED: Dict[str, Dict[str, object]] = {
    # language pretraining (:96-125)
    "task_textmlm_base": dict(
        exp_name="textmlm_base", **_textmlm("vlmo_base_patch16")),
    "task_textmlm_base_plus": dict(
        exp_name="textmlm_base_plus", **_textmlm("vlmo_base_plus_patch16")),
    # vision-language pretraining (:128-175)
    "task_mlm_itm_itc_base": dict(
        exp_name="mlm_itm_itc_base",
        datasets=["vqa"],
        loss_names=loss_names({"itm": 0, "mlm": 1, "itc": 0, "vqa": 1}),
        batch_size=1024,
        whole_word_masking=True,
        learning_rate=2e-4,
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        model_arch="vlmo_base_patch16",
    ),
    "task_mlm_itm_itc_base_plus": dict(
        exp_name="mlm_itm_itc_base_plus",
        datasets=["coco", "vg", "sbu", "gcc"],
        loss_names=loss_names({"itm": 1, "mlm": 1, "itc": 1}),
        batch_size=1024,
        whole_word_masking=True,
        learning_rate=1e-4,
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        model_arch="vlmo_base_plus_patch16",
    ),
    "task_mlm_itm_itc_large": dict(
        exp_name="mlm_itm_itc_large",
        datasets=["vqa"],
        loss_names=loss_names({"itm": 0, "mlm": 1, "itc": 0, "vqa": 1}),
        batch_size=1024,
        whole_word_masking=True,
        learning_rate=5e-5,
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        model_arch="vlmo_large_patch16",
    ),
    "task_mlm_itm": dict(
        exp_name="mlm_itm",
        datasets=["vqa"],
        loss_names=loss_names({"itm": 1, "vqa": 1, "mlm": 1}),
        batch_size=4096,
        max_epoch=10,
        max_image_len=200,
    ),
    # NLVR2 fine-tuning (:178-280)
    "task_finetune_nlvr2_base": dict(
        exp_name="finetune_nlvr2_base",
        **_nlvr2("vlmo_base_patch16", 5e-5)),
    "task_finetune_nlvr2_base_plus": dict(
        exp_name="finetune_nlvr2_base_plus",
        **_nlvr2("vlmo_base_plus_patch16", 3e-5, drop_path_rate=0.2)),
    "task_finetune_nlvr2_base_image384": dict(
        exp_name="finetune_nlvr2_base_image384",
        **_nlvr2("vlmo_base_patch16", 5e-5, image_size=384)),
    "task_finetune_nlvr2_base_plus_image384": dict(
        exp_name="finetune_nlvr2_base_plus_image384",
        **_nlvr2("vlmo_base_plus_patch16", 3e-5, drop_path_rate=0.2,
                 image_size=384)),
    "task_finetune_nlvr2_large": dict(
        exp_name="finetune_nlvr2_large",
        **_nlvr2("vlmo_large_patch16", 3e-5, drop_path_rate=0.15)),
    "task_finetune_nlvr2_large_image384": dict(
        exp_name="finetune_nlvr2_large_image384",
        **_nlvr2("vlmo_large_patch16", 3e-5, drop_path_rate=0.15,
                 image_size=384)),
    # VQAv2 fine-tuning (:283-340) — the attack's entry preset
    "task_finetune_vqa_base_image480": dict(
        exp_name="finetune_vqa_base_image480",
        **_vqa480("vlmo_base_patch16", 3e-5)),
    "task_finetune_vqa_base_plus_image480": dict(
        exp_name="finetune_vqa_base_plus_image480",
        **_vqa480("vlmo_base_plus_patch16", 3e-5)),
    "task_finetune_vqa_large_image480": dict(
        exp_name="finetune_vqa_large_image480",
        **_vqa480("vlmo_large_patch16", 1.5e-5)),
    # F30K / COCO IR+TR fine-tuning (:343-474)
    "task_finetune_irtr_f30k_base": dict(
        exp_name="finetune_irtr_f30k_base",
        **_irtr("f30k", "vlmo_base_patch16", 3e-5, 0.15, 1500, 150)),
    "task_finetune_irtr_f30k_base_image384": dict(
        exp_name="finetune_irtr_f30k_base_image384",
        **_irtr("f30k", "vlmo_base_patch16", 3e-5, 0.15, 1500, 150,
                image_size=384)),
    "task_finetune_irtr_f30k_base_plus_image384": dict(
        exp_name="finetune_irtr_f30k_base_plus_image384",
        **_irtr("f30k", "vlmo_base_plus_patch16", 3e-5, 0.2, 1500, 150,
                image_size=384)),
    "task_finetune_irtr_f30k_large_image384": dict(
        exp_name="finetune_irtr_f30k_large_image384",
        **_irtr("f30k", "vlmo_large_patch16", 2e-5, 0.2, 1500, 150,
                image_size=384)),
    "task_finetune_irtr_coco_base_image384": dict(
        exp_name="finetune_irtr_coco_base_image384",
        **_irtr("coco", "vlmo_base_patch16", 3e-5, 0.2, 3000, 300,
                image_size=384)),
    "task_finetune_irtr_coco_base_plus_image384": dict(
        exp_name="finetune_irtr_coco_base_plus_image384",
        **_irtr("coco", "vlmo_base_plus_patch16", 3e-5, 0.2, 3000, 300,
                image_size=384)),
    "task_finetune_irtr_coco_large_image384": dict(
        exp_name="finetune_irtr_coco_large_image384",
        **_irtr("coco", "vlmo_large_patch16", 2e-5, 0.2, 3000, 300,
                image_size=384)),
    # step-count presets (:482-507), orthogonal, composed after the task
    "step1_5k": dict(max_epoch=100, warmup_steps=150, max_steps=1500),
    "step3k": dict(max_epoch=100, warmup_steps=300, max_steps=3000),
    "step200k": dict(max_epoch=200, warmup_steps=2500, max_steps=200000),
    "step500k": dict(max_epoch=500, warmup_steps=2500, max_steps=500000),
}


def vlmo_named_config(*names: str) -> Dict[str, object]:
    """Resolve ``python run.py with <names...>`` the way sacred does: the
    base config updated by each named config left-to-right."""
    cfg = dict(VLMO_BASE)
    for name in names:
        try:
            cfg.update(NAMED[name])
        except KeyError:
            raise KeyError(
                f"unknown named config {name!r}; available: {sorted(NAMED)}"
            ) from None
    return cfg


# model_arch registry geometry (``multiway_transformer.py:385-412``)
_ARCHS = {
    "vlmo_base_patch16": dict(
        hidden_size=768, depth=12, num_heads=12, vlffn_start_layer=10),
    "vlmo_large_patch16": dict(
        hidden_size=1024, depth=24, num_heads=16, vlffn_start_layer=21),
    "vlmo_base_plus_patch16": dict(
        hidden_size=544, depth=24, num_heads=16, vlffn_start_layer=21,
        use_abs_pos_emb=True, need_relative_position_embed=False,
        layer_scale_init=None),
}


def vlmo_config_from_named(named: Dict[str, object]):
    """Bridge a resolved named-config dict to the port's typed
    :class:`~vqattack_tpu_torch.config.VLMoConfig`."""
    from vqattack_tpu_torch.config import VLMoConfig

    kw = dict(_ARCHS[str(named["model_arch"])])
    kw.update(
        image_size=int(named["image_size"]),
        max_text_len=int(named["max_text_len"]),
        vocab_size=int(named["vocab_size"]),
        vqa_label_size=int(named["vqav2_label_size"]),
        drop_path_rate=float(named["drop_path_rate"]),
    )
    return VLMoConfig(**kw)


def train_settings_from_named(named: Dict[str, object]) -> Dict[str, object]:
    """The optimizer/schedule/data knobs the training CLI consumes."""
    return dict(
        datasets=list(named["datasets"]),
        loss_names=dict(named["loss_names"]),
        batch_size=int(named["batch_size"]),
        learning_rate=float(named["learning_rate"]),
        weight_decay=float(named["weight_decay"]),
        decay_power=named["decay_power"],
        max_epoch=named["max_epoch"],
        max_steps=named["max_steps"],
        warmup_steps=named["warmup_steps"],
        end_lr=float(named["end_lr"]),
        lr_mult=float(named["lr_mult"]),
        whole_word_masking=bool(named["whole_word_masking"]),
        mlm_prob=float(named["mlm_prob"]),
        get_recall_metric=bool(named["get_recall_metric"]),
        k_test=int(named["k_test"]),
    )

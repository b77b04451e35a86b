#!/bin/bash
# End-to-end four-stage MicroDiT training of the PyTorch port on one H100 (the
# repository's train_e2e.sh with the port's entry point and its H100 overlays):
# 256px masked pretrain -> 256px unmasked finetune -> 512px masked -> 512px
# unmasked, each stage loading the previous stage's checkpoint as its recipe says
# (stage 2 and stage 4 the full state, stage 3 the weights only, across the
# 256 -> 1024-token pos_embed change). Extra arguments (key=value overrides) go to
# every stage, e.g. model.dit_arch=MicroDiT_Tiny_2 dataset.train.datadir=...
#
#     bash micro_diffusion_tpu_torch/train_e2e.sh [key=value ...]
set -e

PY=${PYTHON:-python}
HERE=$(cd "$(dirname "$0")" && pwd)
OVERLAYS="$HERE/configs/h100_1gpu"
RUN="$PY -m micro_diffusion_tpu_torch.train --config-path $OVERLAYS"

$RUN --config-name res_256_pretrain "$@"

$RUN --config-name res_256_finetune \
    trainer.load_path=./trained_models/MicroDiTXL_mask_75_res_256_pretrain/ "$@"

$RUN --config-name res_512_pretrain \
    trainer.load_path=./trained_models/MicroDiTXL_mask_0_res_256_finetune/ "$@"

$RUN --config-name res_512_finetune \
    trainer.load_path=./trained_models/MicroDiTXL_mask_75_res_512_pretrain/ "$@"

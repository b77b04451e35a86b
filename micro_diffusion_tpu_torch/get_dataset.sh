#!/bin/bash
# Download -> convert -> precompute one dataset with the PyTorch port (the
# repository's scripts/get_dataset.sh with the port's modules: no JAX anywhere).
# The per-dataset download and convert steps are
# micro_diffusion_tpu_torch/datasets/prepare/{jdb,diffdb,cc12m,sa1b,textcaps,coco}.py;
# the precompute is micro_diffusion_tpu_torch.datasets.prepare.precompute, on the
# card unless --device says otherwise.
#
# Usage:
#   bash micro_diffusion_tpu_torch/get_dataset.sh <jdb|diffdb|cc12m|sa1b|textcaps|coco> \
#       <datadir> [small] [--device cuda|cpu] [--skip-download] [-- PRECOMPUTE_ARGS...]
#
#   small:           ~1% subset for initial experimentation (reference README.md:26)
#   --device:        the precompute's device (default cuda)
#   --skip-download: the raw files are already where the download puts them
#   after --:        more arguments for every precompute call (e.g. --batch_size 64,
#                    --image_resolutions 256, --text_encoder <local snapshot>)
#
# The precompute reads local snapshots of the VAE, the text encoder and the tokenizer
# (set VAE_WEIGHTS_DIR / TEXT_ENCODER_WEIGHTS_DIR / TOKENIZER_DIR). sa1b also needs
# SA1B_LINKS_FILE (the rotating tar-URL file saved from
# https://ai.meta.com/datasets/segment-anything-downloads/).
set -e

PY=${PYTHON:-python}
DATASET=$1
DATADIR=$2
shift 2 || { echo "usage: $0 <dataset> <datadir> [small] [--device D] [--skip-download]" >&2; exit 1; }
SUBSET=full
DEVICE=cuda
DOWNLOAD=1
EXTRA=()
while [ $# -gt 0 ]; do
  case "$1" in
    small) SUBSET=small ;;
    --device) DEVICE=$2; shift ;;
    --skip-download) DOWNLOAD=0 ;;
    --) shift; EXTRA=("$@"); break ;;
    *) echo "unknown argument: $1" >&2; exit 1 ;;
  esac
  shift
done
PKG=micro_diffusion_tpu_torch.datasets.prepare

download() {
  if [ "$DOWNLOAD" = 1 ]; then $PY -m "$PKG.$DATASET" download "$@"; fi
}

case "$DATASET" in
  jdb)
    IDS=""
    if [ "$SUBSET" = "small" ]; then IDS="--valid_ids 0 1"; fi
    download --datadir "$DATADIR/raw" $IDS
    $PY -m $PKG.jdb convert \
        --images_dir "$DATADIR/raw/raw/train/imgs" \
        --captions_jsonl "$DATADIR/raw/raw/train/train_anno_realease_repath.jsonl" \
        --local_mds_dir "$DATADIR/mds"
    ;;
  diffdb)
    IDS=""
    if [ "$SUBSET" = "small" ]; then IDS="--valid_ids $(seq 1 140 | tr '\n' ' ')"; fi
    download --datadir "$DATADIR/raw" $IDS
    $PY -m $PKG.diffdb convert \
        --images_dir "$DATADIR/raw/raw" --local_mds_dir "$DATADIR/mds" \
        --safety_threshold 0.2
    ;;
  cc12m)
    IDS=""
    if [ "$SUBSET" = "small" ]; then IDS="--valid_ids $(seq 0 21 | tr '\n' ' ')"; fi
    download --datadir "$DATADIR/wds" $IDS
    $PY -m $PKG.cc12m convert \
        --wds_dir "$DATADIR/wds" --local_mds_dir "$DATADIR/mds"
    ;;
  sa1b)
    FRACTION=1.0
    if [ "$SUBSET" = "small" ]; then FRACTION=0.01; fi
    if [ "$DOWNLOAD" = 1 ]; then
      $PY -m $PKG.sa1b download --datadir "$DATADIR/raw" \
          --links_file "${SA1B_LINKS_FILE:?set SA1B_LINKS_FILE}" \
          --data_fraction "$FRACTION" --skip_existing
    fi
    $PY -m $PKG.sa1b convert \
        --images_dir "$DATADIR/raw/raw" --captions_dir "$DATADIR/raw/captions" \
        --local_mds_dir "$DATADIR/mds"
    ;;
  textcaps)
    # one command: the HF dataset is read and written in one pass
    $PY -m $PKG.textcaps --local_mds_dir "$DATADIR/mds"
    ;;
  coco)
    download --datadir "$DATADIR/raw"
    $PY -m $PKG.coco convert --datadir "$DATADIR/raw" \
        --local_mds_dir "$DATADIR/mds"
    ;;
  *)
    echo "unknown dataset: $DATASET" >&2; exit 1
    ;;
esac

precompute() {  # <image mds dir> <latents dir>
  $PY -m $PKG.precompute \
      --dataset "$DATASET" \
      --datadir "$1" \
      --savedir "$2" \
      --vae_weights_dir "${VAE_WEIGHTS_DIR:?set VAE_WEIGHTS_DIR}" \
      --text_encoder_weights_dir "${TEXT_ENCODER_WEIGHTS_DIR:?set TEXT_ENCODER_WEIGHTS_DIR}" \
      --tokenizer_dir "${TOKENIZER_DIR:?set TOKENIZER_DIR}" \
      --device "$DEVICE" "${EXTRA[@]}"
}

precompute "$DATADIR/mds" "$DATADIR/mds_latents_sdxl1_dfnclipH14"

# cc12m also builds a minside >= 512 variant for the 512px stages
# (reference scripts/get_cc12m_dataset.sh:27-31)
if [ "$DATASET" = "cc12m" ]; then
  $PY -m $PKG.cc12m convert \
      --wds_dir "$DATADIR/wds" --min_image_size 512 \
      --local_mds_dir "$DATADIR/mds_minres512"
  precompute "$DATADIR/mds_minres512" "$DATADIR/mds_minres512_latents_sdxl1_dfnclipH14"
fi

#!/usr/bin/env bash
# One-command eval runbook of the PyTorch port: checkpoint + weights dir -> images ->
# FID (+ GenEval), on the card unless --device cpu.
#
#   micro_diffusion_tpu_torch/eval/run_eval.sh CKPT WEIGHTS_DIR OUTDIR \
#       --captions coco30k_captions.json --real coco_val_dir_or_stats.npz \
#       --inception pt_inception.pth [--geneval] [--detections det.json] [...]
#
# CKPT        released torch .pt (either layout) or a checkpoint of the port's trainer
# WEIGHTS_DIR holds the frozen encoder snapshots: vae/ text_encoder/ tokenizer/
#             subdirectories (or a flat single-snapshot dir used for all three)
# OUTDIR      work dir: fid_images/, fid.json, geneval_images/, geneval.json
#
# Mirrors the reference's released-checkpoint eval flow (README.md:55-73):
# 30k COCO-caption generations at 512px -> FID vs COCO val; GenEval prompt
# generations scored from external-detector output. The moment real weights and
# a checkpoint exist, the full eval is this one command.
#
# The same flags as eval/run_eval.sh (the JAX package's), plus --device cuda|cpu.
# Tested end-to-end on the CPU (synthetic tiny weights) by tests/test_torch_eval.py.
set -euo pipefail

usage() { sed -n '2,18p' "$0"; exit 1; }
[ $# -ge 3 ] || usage

CKPT=$1; WEIGHTS_DIR=$2; OUTDIR=$3; shift 3

CAPTIONS="" REAL="" INCEPTION="" DETECTIONS="" RUN_GENEVAL=0 CLIP_WEIGHTS=""
ARCH=MicroDiT_XL_2 LATENT_RES=64 IN_CHANNELS=4 POS_INTERP=2.0
VAE_NAME=stabilityai/stable-diffusion-xl-base-1.0
TE_NAME=openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378
STEPS=30 CFG=5.0 BATCH=16 LIMIT="" SEED=2024
GENEVAL_MANIFEST="" DEVICE=cuda

while [ $# -gt 0 ]; do
  case "$1" in
    --captions) CAPTIONS=$2; shift 2;;
    --real) REAL=$2; shift 2;;
    --inception) INCEPTION=$2; shift 2;;
    --geneval) RUN_GENEVAL=1; shift;;
    --geneval-manifest) GENEVAL_MANIFEST=$2; RUN_GENEVAL=1; shift 2;;
    --detections) DETECTIONS=$2; shift 2;;
    --clip-weights) CLIP_WEIGHTS=$2; shift 2;;
    --arch) ARCH=$2; shift 2;;
    --latent_res) LATENT_RES=$2; shift 2;;
    --in_channels) IN_CHANNELS=$2; shift 2;;
    --pos_interp_scale) POS_INTERP=$2; shift 2;;
    --vae-name) VAE_NAME=$2; shift 2;;
    --text-encoder-name) TE_NAME=$2; shift 2;;
    --steps) STEPS=$2; shift 2;;
    --cfg) CFG=$2; shift 2;;
    --batch) BATCH=$2; shift 2;;
    --limit) LIMIT=$2; shift 2;;
    --seed) SEED=$2; shift 2;;
    --device) DEVICE=$2; shift 2;;
    *) echo "unknown flag: $1"; usage;;
  esac
done

# weights layout: subdirs if present, else the flat dir serves all three roles
VAE_DIR=$WEIGHTS_DIR; TE_DIR=$WEIGHTS_DIR; TOK_DIR=$WEIGHTS_DIR
[ -d "$WEIGHTS_DIR/vae" ] && VAE_DIR=$WEIGHTS_DIR/vae
[ -d "$WEIGHTS_DIR/text_encoder" ] && TE_DIR=$WEIGHTS_DIR/text_encoder
[ -d "$WEIGHTS_DIR/tokenizer" ] && TOK_DIR=$WEIGHTS_DIR/tokenizer
# clip/ = full CLIPModel snapshot for the OFFICIAL GenEval zero-shot color
# judge (upstream geneval classifies detection crops with CLIP); without it
# the scorer falls back to the offline hue heuristic.
[ -z "$CLIP_WEIGHTS" ] && [ -d "$WEIGHTS_DIR/clip" ] && CLIP_WEIGHTS=$WEIGHTS_DIR/clip

mkdir -p "$OUTDIR"
GEN_ARGS=(--checkpoint "$CKPT" --dit_arch "$ARCH" --latent_res "$LATENT_RES"
  --in_channels "$IN_CHANNELS" --pos_interp_scale "$POS_INTERP"
  --vae "$VAE_NAME" --vae_weights_dir "$VAE_DIR"
  --text_encoder "$TE_NAME" --text_encoder_weights_dir "$TE_DIR"
  --tokenizer_dir "$TOK_DIR" --batch_size "$BATCH" --steps "$STEPS"
  --cfg "$CFG" --seed "$SEED" --device "$DEVICE")
[ -n "$LIMIT" ] && GEN_ARGS+=(--limit "$LIMIT")

if [ -n "$CAPTIONS" ]; then
  echo "== [1/2] generating FID images from $CAPTIONS"
  python -m micro_diffusion_tpu_torch.eval.generate_eval_images \
    --captions "$CAPTIONS" --outdir "$OUTDIR/fid_images" "${GEN_ARGS[@]}"

  if [ -n "$REAL" ] && [ -n "$INCEPTION" ]; then
    echo "== [2/2] FID"
    python -m micro_diffusion_tpu_torch.eval.fid \
      --real "$REAL" --fake "$OUTDIR/fid_images" \
      --inception_weights "$INCEPTION" --device "$DEVICE" | tee "$OUTDIR/fid.json"
  else
    echo "skipping FID score (need --real and --inception)"
  fi
fi

if [ "$RUN_GENEVAL" = 1 ]; then
  if [ -z "$GENEVAL_MANIFEST" ]; then
    # default: the vendored official 553-prompt GenEval manifest
    GENEVAL_MANIFEST=$(python - <<'EOF'
import micro_diffusion_tpu_torch.eval as e, os
print(os.path.join(os.path.dirname(e.__file__), "geneval_prompts.jsonl"))
EOF
)
  fi
  echo "== GenEval: generating one image per prompt from $GENEVAL_MANIFEST"
  python - "$GENEVAL_MANIFEST" "$OUTDIR/geneval_prompts.json" <<'EOF'
import json, sys
rows = [json.loads(l) for l in open(sys.argv[1]) if l.strip()]
json.dump([r["prompt"] for r in rows], open(sys.argv[2], "w"))
EOF
  python -m micro_diffusion_tpu_torch.eval.generate_eval_images \
    --captions "$OUTDIR/geneval_prompts.json" --outdir "$OUTDIR/geneval_images" \
    "${GEN_ARGS[@]}"
  if [ -n "$DETECTIONS" ]; then
    CLIP_ARGS=()
    [ -n "$CLIP_WEIGHTS" ] && CLIP_ARGS=(--clip_weights_dir "$CLIP_WEIGHTS" \
                                         --clip_tokenizer_dir "$TOK_DIR")
    python -m micro_diffusion_tpu_torch.eval.geneval evaluate \
      --manifest "$GENEVAL_MANIFEST" --detections "$DETECTIONS" \
      --images_dir "$OUTDIR/geneval_images" --device "$DEVICE" \
      --results_jsonl "$OUTDIR/geneval_results.jsonl" \
      "${CLIP_ARGS[@]+"${CLIP_ARGS[@]}"}" | tee "$OUTDIR/geneval.json"
  else
    cat <<MSG
GenEval images are in $OUTDIR/geneval_images.
Run an object detector (upstream uses mmdet Mask2Former) to produce a
detections json, then finish with:
  python -m micro_diffusion_tpu_torch.eval.geneval evaluate \\
    --manifest $GENEVAL_MANIFEST --detections det.json \\
    --images_dir $OUTDIR/geneval_images --device $DEVICE > $OUTDIR/geneval.json
MSG
  fi
fi
echo "done -> $OUTDIR"

#!/usr/bin/env bash
# The flagship campaign's held-out runs of ROADMAP C.4 on the card, on the
# ray-traced scene outputs/vendor_scene_800 (make it first, ~3 min on a CPU:
#   python scripts/make_vendor_scene.py --out outputs/vendor_scene_800 \
#       --width 800 --height 800 --views 36 --points 30000 --sky-points 4000 --rich)
#
#   a  the JAX package's round-3 recipe (scripts/round3_campaign.sh:94-98)
#      from scratch, 30,000 steps
#   b  the same flags resumed from that JAX run's own step-6,000 checkpoint
#      (artifacts/round3/flagship_vendor/ckpt_6000.npz, read in place)
#   c  run (b)'s recipe (--opacity-reset-interval 3000 --prune-world-scale 2.0
#      --spatial-lr-scale auto) at round 4's 2^24 pair limit
#   s1, s2, s3  card c with --seed 1, 2, 3 (card c is seed 0): the recipe's
#      spread over seeds
#   sh4w  round 4's SH4 scale form (scripts/round4_wrapup.sh:77-83) with
#      --sh-warmup 1000 at a 2^25 pair limit, so that budgets past 2^24 slots
#      stage through K5 (ops/staging.py) instead of truncating
#   w0, w1, w2, w3  card c with --sh-warmup 1000 and --seed 0, 1, 2, 3: the
#      recipe's spread over seeds with the SH bands warmed up
#   c5  ROADMAP C.5: scripts/torch_find_nonfinite.py on card s2's run (replayed
#      to its step 22,500 in outputs/c4_s2 unless ckpt_22500.npz is there), its
#      record and the CPU test's fixture under KEEP_DIR/c5; not scored
#
#   bash scripts/torch_c4_cards.sh KEEP_DIR a b      # cards named together
#                                                    # train at once
#
# Each card trains through scripts/torch_flagship_run.py into
# outputs/c4_<card> and keeps metrics.jsonl, summary.json, the held-out PNGs,
# its report and its log under KEEP_DIR/<card>.  Then eval_cli scores held-out
# views 0, 9, 18, 27 of its final PLY at its limit, 2^24 but 2^25 for sh4w
# (the scoring of scripts/round5_wrapup.sh:31-34), and
# scripts/torch_diagnose_holdout.py (sky-dome line first) reads its final
# checkpoint; card a also scores and diagnoses its step-6,000 checkpoint,
# card b also the JAX run's iteration_6000.ply and ckpt_6000.npz; card a's
# rows are printed beside the JAX run's (torch_flagship_run.py --compare).
set -u
KEEP=$1
shift
SCENE=outputs/vendor_scene_800
JAX_RUN=artifacts/round3/flagship_vendor
ROUND3=(--dataset-root "$SCENE" --holdout 4 --iters 30000 --sh-degree 3
        --densify-until 15000 --checkpoint-interval 2000)
RUN_B=(--dataset-root "$SCENE" --holdout 4 --iters 30000 --opacity-reset-interval 3000
       --prune-world-scale 2.0 --spatial-lr-scale auto)
SH4W=(--dataset-root "$SCENE" --holdout 4 --iters 30000 --sh-degree 4
      --grad-threshold 1e-4 --densify-until 20000 --checkpoint-interval 2500
      --opacity-reset-interval 3000 --prune-world-scale 1.5 --spatial-lr-scale auto
      --max-pairs 8388608 --sh-warmup 1000 --max-pairs-limit 33554432)
SCORE=(--dataset colmap --root "$SCENE" --resize-factor 1.0 --views 0,9,18,27)

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# Build the kernels once, before the runs start together.
python3 -c "from gaussiansplattingmlx_tpu_torch.ops import _kernels; _kernels.LIBRARY.cdll()"

train() {  # card, train_flagship flags...
  local card=$1
  shift
  mkdir -p "$KEEP/$card"
  python3 scripts/torch_flagship_run.py --report "$KEEP/$card/report.json" \
      --keep "$KEEP/$card" -- "$@" --out "outputs/c4_$card" > "$KEEP/$card/log.txt" 2>&1
  echo "card $card: train rc=$? $(tail -n 1 "$KEEP/$card/log.txt")"
}

score() {  # tag, ply[, budget]
  mkdir -p "$KEEP/scores"
  python3 -m gaussiansplattingmlx_tpu_torch.eval_cli "${SCORE[@]}" --ply "$2" \
      --max-pairs "${3:-16777216}" --save-renders "$KEEP/scores/$1" \
      > "$KEEP/scores/$1.txt" 2>&1
  echo "score $1 rc=$?: $(tail -n 1 "$KEEP/scores/$1.txt")"
}

diagnose() {  # tag, ckpt[, budget]
  mkdir -p "$KEEP/scores"
  python3 scripts/torch_diagnose_holdout.py "$2" --dataset-root "$SCENE" \
      --max-pairs "${3:-16777216}" > "$KEEP/scores/diagnose_$1.txt" 2>&1
  echo "diagnose $1 rc=$?: $(head -n 1 "$KEEP/scores/diagnose_$1.txt")"
}

for card in "$@"; do
  case $card in
    a) train a "${ROUND3[@]}" & ;;
    b) train b "${ROUND3[@]}" --resume "$JAX_RUN/ckpt_6000.npz" & ;;
    c) train c "${RUN_B[@]}" --max-pairs-limit 16777216 & ;;
    s[123]) train "$card" "${RUN_B[@]}" --max-pairs-limit 16777216 --seed "${card#s}" & ;;
    w[0123]) train "$card" "${RUN_B[@]}" --max-pairs-limit 16777216 --sh-warmup 1000 --seed "${card#w}" & ;;
    c5)
      mkdir -p "$KEEP/c5"
      python3 scripts/torch_find_nonfinite.py --start 22500 --until 25000 \
          --record "$KEEP/c5/record.npz" --fixture "$KEEP/c5/fixture.npz" -- \
          "${RUN_B[@]}" --max-pairs-limit 16777216 --seed 2 --out outputs/c4_s2 \
          > "$KEEP/c5/log.txt" 2>&1 &
      ;;
    sh4w) train sh4w "${SH4W[@]}" & ;;
    *) echo "unknown card $card" >&2; exit 2 ;;
  esac
done
wait

for card in "$@"; do
  [ "$card" = c5 ] && { echo "c5: $(tail -n 1 "$KEEP/c5/log.txt")"; continue; }
  budget=16777216
  [ "$card" = sh4w ] && budget=33554432
  score "${card}_30000" "outputs/c4_$card/iteration_30000.ply" "$budget"
  diagnose "${card}_30000" "outputs/c4_$card/ckpt_30000.npz" "$budget"
  case $card in
    a)
      python3 scripts/torch_ckpt_to_ply.py outputs/c4_a/ckpt_6000.npz \
          -o outputs/c4_a/iteration_6000.ply
      score a_6000 outputs/c4_a/iteration_6000.ply
      diagnose a_6000 outputs/c4_a/ckpt_6000.npz
      python3 scripts/torch_flagship_run.py --compare "$KEEP/a/metrics.jsonl" \
          "$JAX_RUN/metrics.jsonl" > "$KEEP/a/compare_round3.txt"
      tail -n 2 "$KEEP/a/compare_round3.txt" ;;
    b)
      score jax_6000 "$JAX_RUN/iteration_6000.ply"
      diagnose jax_6000 "$JAX_RUN/ckpt_6000.npz" ;;
  esac
done

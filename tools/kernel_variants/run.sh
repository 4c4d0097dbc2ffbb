#!/bin/bash
# Build the variant timers of B1 to B6 (or those named) with nvcc and run
# them on the card:
#   bash tools/kernel_variants/run.sh [b1] [b2] [b3] [b4] [b5] [b6]
# Each prints one JSON line per size or input, device us a launch.
set -e
cd "$(dirname "$0")"
out=../../particles_tpu_torch/_build/variants
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
flags="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v"
nvcc=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
names=${*:-b1 b2 b3 b4 b5 b6}
pids=()
for n in $names; do
  "$nvcc" $flags -o "$out/${n}_variants" "${n}_variants.cu" &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done
for n in $names; do
  timeout 300 "$out/${n}_variants"
done

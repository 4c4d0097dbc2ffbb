#!/bin/bash
# Build the variant timers of B2 and B3 with nvcc and run them on the card:
#   bash tools/kernel_variants/run.sh
# Each prints one JSON line per size or offspring shape, device us a launch.
set -e
cd "$(dirname "$0")"
out=../../particles_tpu_torch/_build/variants
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
flags="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3"
nvcc=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
"$nvcc" $flags -o "$out/b3_variants" b3_variants.cu &
"$nvcc" $flags -o "$out/b2_variants" b2_variants.cu &
wait
timeout 300 "$out/b3_variants"
timeout 300 "$out/b2_variants"

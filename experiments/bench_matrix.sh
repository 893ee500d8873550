#!/bin/bash
# Bench matrix on one GPU.  Lines MERGE into BENCH_MATRIX.jsonl keyed
# by metric name (merge_matrix.py): a partial rerun updates only the
# configs it measured and never shrinks the matrix.
set -u
cd "$(dirname "$0")/.."
out=BENCH_MATRIX.jsonl
run() {
    echo "=== $* ===" >&2
    # NOT `tee /dev/stderr`: when stderr is a redirected file, tee
    # reopens it with O_TRUNC and each run erases the log of the last.
    timeout 1800 python bench.py "$@" 2>&1 | tee >(cat >&2) | grep '^{' \
        | python experiments/merge_matrix.py "$out"
}
run --quant q4_0 --tokens 256
run --quant q4_k --tokens 192
run --quant q4_0 --ctx 2048 --prompt-tokens 1024 --tokens 256 --kv int8
run --quant q8_0 --tokens 128
run --quant f16 --tokens 64
run --quant q4_0 --mode ttft --prompt-tokens 512
run --quant q4_0 --batch 8 --ctx 1024 --tokens 128
run --quant q4_0 --mode serve --requests 24 --batch 8 --ctx 1024 \
    --prompt-tokens 128 --tokens 64
run --quant q4_0 --mode serve --requests 24 --batch 8 --ctx 1024 \
    --prompt-tokens 384 --tokens 64 --prefix-cache
# Long-context serving with int8 pages (the kv-int8 decode config's
# serving counterpart).
run --quant q4_0 --mode serve --requests 24 --batch 8 --ctx 2048 \
    --prompt-tokens 128 --tokens 64 --kv int8
# BASELINE config 4: 13B q4_0 on one card (~7.3 GB weights).
run --model 13b --quant q4_0 --tokens 192
run --model 13b --quant q4_0 --mode serve --requests 16 --batch 8 \
    --ctx 512 --prompt-tokens 128 --tokens 64
run --model 13b --quant q4_0 --mode serve --requests 16 --batch 8 \
    --ctx 1024 --prompt-tokens 128 --tokens 64 --kv int8

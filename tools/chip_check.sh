#!/usr/bin/env bash
# Every card check of the port, run from the root of a checkout on a machine
# with one CUDA card, nvcc and PyTorch built for CUDA:
#
#     bash tools/chip_check.sh [OUT_DIR] [PARENT_SRC]
#
# In order: chip_smoke.py; chip_smoke.py copied alone into an empty
# directory, which must fail; the card tests (tests/test_torch_cuda.py);
# faults planted in a copy of the STO kernel, then of the flash kernel,
# then of the delay-line kernel, against them (tools/plant_faults.py);
# field_tiled at every cluster size, as the source stands and as its regs128
# variant
# (tools/field_split_sweep.py); the loops' instruction mix, STO, delay line
# and flash (tools/sto_sass_mix.py); and, given PARENT_SRC (the src/ of an
# older checkout), field_tiled, rk4_tiled_step and round_bf16, then the
# delay line, then the flash kernel, of that checkout against this one's, in
# the order parent, this, this, parent (twice for field_tiled, whose bf16
# hold window swings with a run's position; tools/field_tiled_time.py,
# tools/delay_line_time.py, tools/flash_time.py). Each step writes its
# whole output to OUT_DIR/<step>.txt (default OUT_DIR:
# chiprun_out/chip_check) and prints its exit code and the end of its
# output. Exits non-zero if a step failed.

set -u
out=${1:-chiprun_out/chip_check}
parent=${2:-}
mkdir -p "$out"
out=$(cd "$out" && pwd)
failed=0

step() {  # step NAME EXPECT TAIL_BYTES TIMEOUT COMMAND...
    local name=$1 expect=$2 tail_bytes=$3 limit=$4
    shift 4
    timeout -k 10 "$limit" "$@" >"$out/$name.txt" 2>&1
    local rc=$?
    echo "== $name: rc=$rc"
    grep -v "ptxas\|Compiling entry\|Function properties\|bytes stack frame\|Used [0-9]* registers\|^== " \
        "$out/$name.txt" | tail -c "$tail_bytes"
    if { [ "$expect" = ok ] && [ $rc -ne 0 ]; } || { [ "$expect" = fail ] && [ $rc -eq 0 ]; }; then
        echo "== $name: FAILED (expected $expect)"
        failed=1
    fi
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
step smoke ok 9000 1100 python3 chip_smoke.py
alone=$(mktemp -d)
cp chip_smoke.py "$alone/"
step smoke_alone fail 400 300 bash -c "cd '$alone' && python3 chip_smoke.py"
rm -rf "$alone"
step card_tests ok 800 600 env PYTHONPATH=src python3 -m pytest tests/test_torch_cuda.py -q \
    -p no:cacheprovider
step plant_faults ok 3000 1500 python3 tools/plant_faults.py
step plant_faults_flash ok 3000 1200 python3 tools/plant_faults.py --kernel flash
step plant_faults_delay ok 1500 900 python3 tools/plant_faults.py --kernel delay
step split_sweep ok 6000 600 python3 tools/field_split_sweep.py --variant regs128
step sass_mix ok 9000 300 python3 tools/sto_sass_mix.py
if [ -n "$parent" ]; then
    step parent_vs_this ok 4000 1200 bash -c "
        for src in '$parent' src src '$parent' '$parent' src src '$parent'; do
            python3 tools/field_tiled_time.py --src \"\$src\" || exit 1
        done"
    step delay_parent_vs_this ok 2000 600 bash -c "
        for src in '$parent' src src '$parent'; do
            python3 tools/delay_line_time.py --src \"\$src\" || exit 1
        done"
    step flash_parent_vs_this ok 6000 900 bash -c "
        for src in '$parent' src src '$parent'; do
            python3 tools/flash_time.py --src \"\$src\" || exit 1
        done"
fi
exit $failed

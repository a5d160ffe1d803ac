#!/bin/bash
# chip_smoke.py's readings of two trees, taken in one process slot on one
# card: the parent commit's package under this tree's chip_smoke.py (the old
# kernels under the new timing and checks) against this tree's committed
# files alone, in the order parent, change, change, parent, then the
# cuda-marked tests of the change.
#
#   scripts/ab_chip_smoke.sh prepare PARENT
#       in a git checkout, from the repo root: unpacks PARENT with this
#       tree's chip_smoke.py into _ab/parent and the committed files of the
#       working tree (git add -A; git write-tree) into _ab/change.
#       .gitignore lists _ab/.
#   scripts/ab_chip_smoke.sh run [OUTDIR [KEXPR]]
#       on a machine with one CUDA device, from the repo root: the four
#       runs and the tests, each log under OUTDIR/ab_*.log (default
#       _ab/logs), and a summary of each run on standard output. With
#       KEXPR, also the change's kernel tests that `pytest -k KEXPR` selects,
#       on the parent's package (a test that must fail there).
set -u
case "${1:-}" in
  prepare)
    parent=${2:?usage: $0 prepare PARENT}
    rm -rf _ab/parent _ab/change
    mkdir -p _ab/parent _ab/change
    git add -A
    git archive "$parent" | tar -x -C _ab/parent
    git show "$(git write-tree):chip_smoke.py" > _ab/parent/chip_smoke.py
    git archive "$(git write-tree)" | tar -x -C _ab/change
    echo "parent $(git rev-parse --short "$parent"), change tree" \
      "$(git write-tree)"
    ;;
  run)
    out=$PWD/${2:-_ab/logs}
    mkdir -p "$out"
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    n=0
    for tree in parent change change parent; do
      n=$((n + 1))
      log=$out/ab_${n}_$tree.log
      (cd "_ab/$tree" && timeout 1200 python3 chip_smoke.py) > "$log" 2>&1
      echo "run $n ($tree): rc=$? in $SECONDS s"
      grep -E "faces/s=|kernels take|_bwd call|^FAILED" "$log" \
        | cut -c1-240
      tail -2 "$log" | cut -c1-240
    done
    (cd _ab/change && timeout 900 python3 -m pytest --noconftest -m cuda -q \
      -p no:cacheprovider tests/test_torch_kernels_cuda.py \
      tests/test_torch_guards.py) > "$out/ab_tests.log" 2>&1
    echo "tests: rc=$?"
    tail -2 "$out/ab_tests.log"
    if [ -n "${3:-}" ]; then
      cp _ab/change/tests/test_torch_kernels_cuda.py \
        _ab/parent/tests/test_torch_kernels_cuda_of_change.py
      (cd _ab/parent && timeout 600 python3 -m pytest --noconftest -m cuda \
        -q -p no:cacheprovider -k "$3" \
        tests/test_torch_kernels_cuda_of_change.py) \
        > "$out/ab_parent_tests.log" 2>&1
      echo "the change's tests '$3' on the parent: rc=$?"
      tail -2 "$out/ab_parent_tests.log"
    fi
    ;;
  *)
    echo "usage: $0 prepare PARENT | run" >&2
    exit 2
    ;;
esac

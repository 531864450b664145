#!/usr/bin/env bash
# The benchmark's cells on two checkouts in turns, on one card: for each
# cell and seed, both sides run `perfbench/run.py --seconds SECONDS
# --trace 0` with the same seed, the side that runs first alternating.
# Each run's stdout and stderr go to OUT/<side>.<cell>.<seed>.{json,err};
# one line a run on stdout gives its exit status and the start of its
# result line.
#
#   scripts/ab_bench.sh OUT SECONDS "SEED ..." SIDE_A SIDE_B CELL ...
#
# e.g. (a parent unpacked with `git archive` into an ignored directory):
#   scripts/ab_bench.sh build/ab 30 "2147001001 3000000017" \
#       chip_trees/parent chip_trees/change case33_mappo.train512
set -u
out=$1 seconds=$2 seeds=$3 a=$4 b=$5
shift 5
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
run() {  # side cell seed
  local name
  name=$(basename "$1")
  (cd "$1" && python3 perfbench/run.py --workload "$2" --seed "$3" --seconds "$seconds" \
     --trace 0 > "$out/$name.$2.$3.json" 2> "$out/$name.$2.$3.err")
  echo "$name $2 $3 rc=$? $(tail -n 1 "$out/$name.$2.$3.json" | cut -c 1-300)"
}
i=0
for cell in "$@"; do
  for seed in $seeds; do
    s=$((seed + i))
    if [ $((i % 2)) -eq 0 ]; then run "$a" "$cell" "$s"; run "$b" "$cell" "$s"
    else run "$b" "$cell" "$s"; run "$a" "$cell" "$s"; fi
    i=$((i + 1))
  done
done

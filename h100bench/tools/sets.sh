# The runs the bounds were set from: for each cell two sets of 6 runs with
# the same 6 seeds, then 3 traced runs on other seeds, one JSON line a run
# in chiprun_out/sets_<cell>.jsonl.  From the root of a checkout on a card:
#     bash h100bench/tools/sets.sh SECONDS CELL [CELL...]
mkdir -p chiprun_out
sec=$1; shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for cell in "$@"; do
  for set in 1 2; do
    for seed in 2147483701 2147483743 2147483787 2147483829 2147483871 2147483913; do
      s=$(date +%s)
      python3 -m h100bench.run --workload $cell --seed $seed --seconds $sec --trace 0 > chiprun_out/run.out 2> chiprun_out/run.err
      rc=$?
      echo "{\"cell\": \"$cell\", \"set\": $set, \"seed\": $seed, \"trace\": 0, \"rc\": $rc, \"wall\": $(( $(date +%s) - s )), \"line\": $(tail -n 1 chiprun_out/run.out | grep '^{' || echo null)}" | tee -a chiprun_out/sets_$cell.jsonl | cut -c1-330
      [ $rc -ne 0 ] && tail -n 5 chiprun_out/run.err
    done
  done
  for seed in 2147483959 2147484001 2147484043; do
    s=$(date +%s)
    python3 -m h100bench.run --workload $cell --seed $seed --seconds $sec --trace 1 > chiprun_out/run.out 2> chiprun_out/run.err
    rc=$?
    echo "{\"cell\": \"$cell\", \"set\": 0, \"seed\": $seed, \"trace\": 1, \"rc\": $rc, \"wall\": $(( $(date +%s) - s )), \"line\": $(tail -n 1 chiprun_out/run.out | grep '^{' || echo null)}" | tee -a chiprun_out/sets_$cell.jsonl | cut -c1-330
    [ $rc -ne 0 ] && tail -n 5 chiprun_out/run.err
  done
done

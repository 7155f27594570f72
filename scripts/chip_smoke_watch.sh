#!/bin/bash
# Runs chip_smoke.py in a session of its own and lists what it left behind.
#
#   bash scripts/chip_smoke_watch.sh TAG [DIR]
#
# DIR (default: the repo root) holds the chip_smoke.py to run, for example an
# unpacked `git archive`. Writes into the repo's chiprun_out/: the process
# table before, during (every 10 s) and after the run, and the script's
# stdout and stderr. Prints the exit code, the wall seconds, every process of
# the script's session still alive after it ended, every process new since
# the start, and any leftover the script stopped itself.
tag=$1; dir=${2:-.}
out="$(cd "$(dirname "$0")/.." && pwd)/chiprun_out"
mkdir -p "$out"
ps -eo pid,ppid,pgid,sid,etimes,stat,args > "$out/ps_before_$tag.txt"
cd "$dir" || exit 9
start=$(date +%s)
setsid python3 chip_smoke.py > "$out/smoke_$tag.log" 2> "$out/smoke_$tag.err" &
pid=$!
while kill -0 "$pid" 2>/dev/null; do
  ps -eo pid,ppid,etimes,stat,args --forest > "$out/ps_last_$tag.txt"; sleep 10
done
wait "$pid"; rc=$?
end=$(date +%s)
sleep 2
ps -eo pid,ppid,pgid,sid,etimes,stat,args > "$out/ps_after_$tag.txt"
echo "smoke_rc=$rc seconds=$((end-start))"
echo "session leftovers:"; ps -eo pid,sid,stat,args | awk -v s="$pid" '$2==s'
echo "new processes:"
comm -13 <(awk 'NR>1{print $1}' "$out/ps_before_$tag.txt" | sort) \
         <(awk 'NR>1{print $1}' "$out/ps_after_$tag.txt" | sort) |
  while read -r p; do grep -E "^ *$p " "$out/ps_after_$tag.txt"; done
grep -a "leftover" "$out/smoke_$tag.err"
tail -3 "$out/smoke_$tag.log"

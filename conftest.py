# Build outputs, chip-run results and unpacked copies of other commits live in
# these ignored directories; their test files belong to those copies and would
# clash by module name with the repo's own.
collect_ignore = ["build", "checkout", "chiprun_out"]

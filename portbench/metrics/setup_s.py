"""setup_s: seconds from the process's start to the window's start
(environment or params, kernel load or build, warm-up, the checked
steps), host clock."""


def read(rec):
    return rec["setup_s"]

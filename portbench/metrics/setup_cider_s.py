"""Host seconds inside ``DeviceCider``'s builds (the train and val scorers'
tables) during set-up."""


def read(run):
    return run["spans"].get("cider_s")

"""RSC15 (RecSys Challenge 2015 / yoochoose-clicks) preprocessing.

Same filtering/splitting protocol as the reference
(examples/rsc15/preprocess.py), in the same code as the JAX package's
examples/rsc15/preprocess.py: drop length-1 sessions, drop items with
support < 5, re-drop short sessions; last-day sessions form the test set
(items restricted to the train vocabulary), and the same split is applied
once more to carve a validation set out of the training days.

Usage: python -m gru4rec_tpu_torch.examples.rsc15.preprocess \\
           <path/to/yoochoose-clicks.dat> <output_dir>

It writes rsc15_train_full.txt, rsc15_test.txt, rsc15_train_tr.txt and
rsc15_train_valid.txt into <output_dir>.
"""

import datetime as dt
import sys

import numpy as np
import pandas as pd


def split_last_day(data, out_prefix, train_name, test_name):
    tmax = data.Time.max()
    session_max_times = data.groupby("SessionId").Time.max()
    train_sessions = session_max_times[session_max_times < tmax - 86400].index
    test_sessions = session_max_times[session_max_times >= tmax - 86400].index
    train = data[np.isin(data.SessionId, train_sessions)]
    test = data[np.isin(data.SessionId, test_sessions)]
    test = test[np.isin(test.ItemId, train.ItemId)]
    tslength = test.groupby("SessionId").size()
    test = test[np.isin(test.SessionId, tslength[tslength >= 2].index)]
    print("Train set\n\tEvents: {}\n\tSessions: {}\n\tItems: {}".format(
        len(train), train.SessionId.nunique(), train.ItemId.nunique()))
    train.to_csv(out_prefix + train_name, sep="\t", index=False)
    print("Test set\n\tEvents: {}\n\tSessions: {}\n\tItems: {}".format(
        len(test), test.SessionId.nunique(), test.ItemId.nunique()))
    test.to_csv(out_prefix + test_name, sep="\t", index=False)
    return train


def main(raw_path, out_dir):
    data = pd.read_csv(raw_path, sep=",", header=None, usecols=[0, 1, 2],
                       dtype={0: np.int32, 1: str, 2: np.int64})
    data.columns = ["SessionId", "TimeStr", "ItemId"]
    data["Time"] = data.TimeStr.apply(
        lambda x: dt.datetime.strptime(x, "%Y-%m-%dT%H:%M:%S.%fZ").timestamp())
    del data["TimeStr"]

    session_lengths = data.groupby("SessionId").size()
    data = data[np.isin(data.SessionId, session_lengths[session_lengths > 1].index)]
    item_supports = data.groupby("ItemId").size()
    data = data[np.isin(data.ItemId, item_supports[item_supports >= 5].index)]
    session_lengths = data.groupby("SessionId").size()
    data = data[np.isin(data.SessionId, session_lengths[session_lengths >= 2].index)]

    prefix = out_dir.rstrip("/") + "/"
    train_full = split_last_day(data, prefix, "rsc15_train_full.txt", "rsc15_test.txt")
    split_last_day(train_full, prefix, "rsc15_train_tr.txt", "rsc15_train_valid.txt")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

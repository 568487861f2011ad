"""Non-neural baseline recommenders with the reference's predict protocol.

A copy of ``gru4rec_tpu/baselines/baselines.py`` (numpy, pandas and scipy
only), so that the port imports nothing of the JAX package.

Reference: baselines.py (RandomPred :11-50, Pop :52-118, SessionPop :120-197,
ItemKNN :199-301, BPR :303-419). All expose ``fit(data)``, the per-event
``predict_next(session_id, input_item_id, predict_for_item_ids) -> pd.Series``
protocol, and the session-vectorized
``predict_session(session_id, session_items, predict_for_item_ids)`` used by
``eval.evaluation.evaluate_sessions`` (one call per session instead of one
per event; both produce the same scores).

ItemKNN's similarity build computes co(i,j) = sum over sessions of
supp_s(i)*supp_s(j) as the sparse Gram matrix M'M of the session x item count
matrix, normalized by (supp_i + lambda)^alpha * (supp_j + lambda)^(1-alpha) —
the same quantity as the reference's O(n_items x events) Python loop, with
memory bounded by the number of distinct co-occurring pairs (a dataframe
self-join would materialize sum(session_len^2) rows and explode on
RSC15-scale data).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


class RandomPred:
    """Uniform random scores (reference: baselines.py:11-50)."""

    def __init__(self, rng=None):
        self.rng = rng or np.random.RandomState(0)

    def fit(self, data):
        pass

    def predict_next(self, session_id, input_item_id, predict_for_item_ids):
        return pd.Series(
            data=self.rng.rand(len(predict_for_item_ids)), index=predict_for_item_ids
        )

    def predict_session(self, session_id, session_items, predict_for_item_ids):
        return self.rng.rand(len(session_items) - 1, len(predict_for_item_ids))


class Pop:
    """Global popularity ``supp/(1+supp)``, top-n truncated (baselines.py:52-118)."""

    def __init__(self, top_n=100, item_key="ItemId", support_by_key=None):
        self.top_n = top_n
        self.item_key = item_key
        self.support_by_key = support_by_key

    def fit(self, data):
        grp = data.groupby(self.item_key)
        pop = grp.size() if self.support_by_key is None else grp[self.support_by_key].nunique()
        pop = pop / (pop + 1)
        self.pop_list = pop.sort_values(ascending=False).head(self.top_n)

    def _pop_vector(self, predict_for_item_ids):
        preds = np.zeros(len(predict_for_item_ids))
        mask = np.isin(predict_for_item_ids, self.pop_list.index)
        preds[mask] = self.pop_list[predict_for_item_ids[mask]]
        return preds

    def predict_next(self, session_id, input_item_id, predict_for_item_ids):
        return pd.Series(data=self._pop_vector(predict_for_item_ids),
                         index=predict_for_item_ids)

    def predict_session(self, session_id, session_items, predict_for_item_ids):
        return np.tile(self._pop_vector(predict_for_item_ids),
                       (len(session_items) - 1, 1))


class SessionPop:
    """In-session counts + popularity tie-break (baselines.py:120-197)."""

    def __init__(self, top_n=100, item_key="ItemId", support_by_key=None):
        self.top_n = top_n
        self.item_key = item_key
        self.support_by_key = support_by_key

    def fit(self, data):
        grp = data.groupby(self.item_key)
        pop = grp.size() if self.support_by_key is None else grp[self.support_by_key].nunique()
        pop = pop / (pop + 1)
        self.pop_list = pop.sort_values(ascending=False).head(self.top_n)
        self.prev_session_id = -1

    def predict_next(self, session_id, input_item_id, predict_for_item_ids):
        if self.prev_session_id != session_id:
            self.prev_session_id = session_id
            self.pers = {}
        self.pers[input_item_id] = self.pers.get(input_item_id, 0) + 1
        preds = np.zeros(len(predict_for_item_ids))
        mask = np.isin(predict_for_item_ids, self.pop_list.index)
        preds[mask] = self.pop_list[predict_for_item_ids[mask]]
        ser = pd.Series(self.pers)
        mask = np.isin(predict_for_item_ids, ser.index)
        preds[mask] += ser[predict_for_item_ids[mask]]
        return pd.Series(data=preds, index=predict_for_item_ids)

    def predict_session(self, session_id, session_items, predict_for_item_ids):
        E = len(session_items) - 1
        base = np.zeros(len(predict_for_item_ids))
        mask = np.isin(predict_for_item_ids, self.pop_list.index)
        base[mask] = self.pop_list[np.asarray(predict_for_item_ids)[mask]]
        scores = np.tile(base, (E, 1))
        # in-session count of each input accumulates from its event onward
        pos = pd.Index(predict_for_item_ids).get_indexer(session_items[:-1])
        for t, p in enumerate(pos):
            if p >= 0:
                scores[t:, p] += 1.0
        return scores


class ItemKNN:
    """Item co-occurrence similarity, top n_sims per item (baselines.py:199-301)."""

    def __init__(self, n_sims=100, lmbd=20, alpha=0.5, session_key="SessionId",
                 item_key="ItemId", time_key="Time"):
        self.n_sims = n_sims
        self.lmbd = lmbd
        self.alpha = alpha
        self.session_key = session_key
        self.item_key = item_key
        self.time_key = time_key

    def fit(self, data):
        from scipy import sparse

        itemids = data[self.item_key].unique()
        n_items = len(itemids)
        idmap = pd.Series(np.arange(n_items), index=itemids)
        i_codes = idmap[data[self.item_key].values].values.astype(np.int64)
        s_codes, _ = pd.factorize(data[self.session_key].values)
        supp = np.bincount(i_codes, minlength=n_items)
        # co(i,j) = sum_s supp_s(i)*supp_s(j) = (M'M)_ij with M the
        # session x item count matrix. Sparse Gram keeps memory bounded by
        # the number of DISTINCT co-occurring item pairs; a dataframe
        # self-join materializes sum(session_len^2) rows instead
        M = sparse.csr_matrix(
            (np.ones(len(i_codes), np.float64), (s_codes, i_codes)),
            shape=(int(s_codes.max()) + 1, n_items),
        )
        co = (M.T @ M).tocsr()
        norm_i = (supp + self.lmbd) ** self.alpha
        norm_j = (supp + self.lmbd) ** (1.0 - self.alpha)
        indptr, indices, vals = co.indptr, co.indices, co.data
        sims = {}
        for i in range(n_items):
            j = indices[indptr[i]: indptr[i + 1]]
            c = vals[indptr[i]: indptr[i + 1]]
            keep = j != i
            j, c = j[keep], c[keep]
            val = c / (norm_i[i] * norm_j[j])
            top = np.argsort(val)[::-1][: self.n_sims]
            sims[itemids[i]] = pd.Series(data=val[top], index=itemids[j[top]])
        self.sims = sims

    def predict_next(self, session_id, input_item_id, predict_for_item_ids):
        preds = np.zeros(len(predict_for_item_ids))
        sim_list = self.sims[input_item_id]
        mask = np.isin(predict_for_item_ids, sim_list.index)
        preds[mask] = sim_list[predict_for_item_ids[mask]]
        return pd.Series(data=preds, index=predict_for_item_ids)

    def predict_session(self, session_id, session_items, predict_for_item_ids):
        colmap = pd.Index(predict_for_item_ids)
        out = np.zeros((len(session_items) - 1, len(colmap)))
        for t, inp in enumerate(session_items[:-1]):
            sim_list = self.sims[inp]
            if len(sim_list):
                pos = colmap.get_indexer(sim_list.index)
                ok = pos >= 0
                out[t, pos[ok]] = sim_list.values[ok]
        return out


class BPR:
    """BPR-MF with session-as-user; prediction uses the mean of the session's
    item factors as the session vector (baselines.py:303-419)."""

    def __init__(self, n_factors=100, n_iterations=10, learning_rate=0.01,
                 lambda_session=0.0, lambda_item=0.0, sigma=0.05, init_normal=False,
                 session_key="SessionId", item_key="ItemId", seed=42,
                 batch_size=1):
        self.n_factors = n_factors
        self.n_iterations = n_iterations
        self.learning_rate = learning_rate
        self.lambda_session = lambda_session
        self.lambda_item = lambda_item
        self.sigma = sigma
        self.init_normal = init_normal
        self.session_key = session_key
        self.item_key = item_key
        self.current_session = None
        self.rng = np.random.RandomState(seed)
        # batch_size=1 reproduces the reference's per-event SGD exactly
        # (baselines.py:339-358) but is a pure-Python loop, unusable at
        # RSC15 scale; batch_size>1 applies vectorized mini-batch updates
        # (duplicate-index gradients summed) — the standard batched-BPR
        # approximation, ~1000x faster on large data.
        self.batch_size = batch_size

    def _init(self):
        r = self.rng
        if self.init_normal:
            self.U = r.randn(self.n_sessions, self.n_factors) * self.sigma
            self.I = r.randn(self.n_items, self.n_factors) * self.sigma
        else:
            self.U = r.rand(self.n_sessions, self.n_factors) * 2 * self.sigma - self.sigma
            self.I = r.rand(self.n_items, self.n_factors) * 2 * self.sigma - self.sigma
        self.bU = np.zeros(self.n_sessions)
        self.bI = np.zeros(self.n_items)

    def fit(self, data):
        itemids = data[self.item_key].unique()
        self.n_items = len(itemids)
        self.itemidmap = pd.Series(np.arange(self.n_items), index=itemids)
        sessionids = data[self.session_key].unique()
        self.n_sessions = len(sessionids)
        smap = pd.Series(np.arange(self.n_sessions), index=sessionids)
        uidx = smap[data[self.session_key].values].values
        iidx = self.itemidmap[data[self.item_key].values].values
        self._init()
        lr, ls, li = self.learning_rate, self.lambda_session, self.lambda_item
        for it in range(self.n_iterations):
            costs = []
            order = self.rng.permutation(len(data))
            if self.batch_size <= 1:
                for e in order:
                    u, p = uidx[e], iidx[e]
                    # reference parity incl. its quirk (baselines.py:384):
                    # the negative is drawn as data.ItemIdx[randint(n_items)]
                    # — i.e. from the items of the first n_items EVENTS in
                    # data order, not uniformly over the catalog
                    n = iidx[self.rng.randint(self.n_items)]
                    uF, iF1, iF2 = self.U[u].copy(), self.I[p].copy(), self.I[n].copy()
                    sigm = 1.0 / (1.0 + np.exp(-(iF1 @ uF - iF2 @ uF + self.bI[p] - self.bI[n])))
                    c = 1.0 - sigm
                    self.U[u] += lr * (c * (iF1 - iF2) - ls * uF)
                    self.I[p] += lr * (c * uF - li * iF1)
                    self.I[n] += lr * (-c * uF - li * iF2)
                    # the reference never updates bI (baselines.py:349-358); kept for parity
                    costs.append(np.log(max(sigm, 1e-12)))
                print(it, float(np.mean(costs)))
                continue
            for lo in range(0, len(order), self.batch_size):
                e = order[lo: lo + self.batch_size]
                u, p = uidx[e], iidx[e]
                # the batched branch is this package's own addition: draw
                # negatives uniformly over the CATALOG (deliberately not
                # replicating the reference's first-n_items-events quirk
                # transcribed in the per-event branch above)
                n = self.rng.randint(self.n_items, size=len(e))
                uF, iF1, iF2 = self.U[u], self.I[p], self.I[n]
                sigm = 1.0 / (1.0 + np.exp(
                    -(np.sum((iF1 - iF2) * uF, axis=1) + self.bI[p] - self.bI[n])
                ))
                c = (1.0 - sigm)[:, None]
                gU = c * (iF1 - iF2) - ls * uF
                gP = c * uF - li * iF1
                gN = -c * uF - li * iF2
                np.add.at(self.U, u, lr * gU)
                np.add.at(self.I, p, lr * gP)
                np.add.at(self.I, n, lr * gN)
                costs.append(float(np.mean(np.log(np.maximum(sigm, 1e-12)))))
            print(it, float(np.mean(costs)))

    def predict_next(self, session_id, input_item_id, predict_for_item_ids):
        iidx = self.itemidmap[input_item_id]
        if self.current_session is None or self.current_session != session_id:
            self.current_session = session_id
            self.session = [iidx]
        else:
            self.session.append(iidx)
        uF = self.I[self.session].mean(axis=0)
        iIdxs = self.itemidmap[predict_for_item_ids]
        return pd.Series(data=self.I[iIdxs].dot(uF) + self.bI[iIdxs],
                         index=predict_for_item_ids)

    def predict_session(self, session_id, session_items, predict_for_item_ids):
        # session vector at event t = mean of the first t+1 input factors
        # (predict_next appends the input before averaging)
        iidx = self.itemidmap[np.asarray(session_items[:-1])].values
        uF = np.cumsum(self.I[iidx], axis=0) / np.arange(1, len(iidx) + 1)[:, None]
        cols = self.itemidmap[np.asarray(predict_for_item_ids)].values
        return uF @ self.I[cols].T + self.bI[cols]

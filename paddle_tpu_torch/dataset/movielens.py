"""MovieLens ratings. Parity: reference python/paddle/dataset/movielens.py
and the JAX package's dataset/movielens.py: the same synthetic ratings,
catalog and users, sample for sample, since neither package downloads.
`convert` (recordio) waits for the trainer-and-data slice of the port."""
import numpy as np

from . import common

__all__ = ['train', 'test', 'max_user_id', 'max_movie_id', 'max_job_id',
           'age_table', 'movie_categories', 'get_movie_title_dict',
           'movie_info', 'user_info', 'MovieInfo', 'UserInfo']

age_table = [1, 18, 25, 35, 45, 50, 56]

_CATEGORIES = ['Action', 'Adventure', 'Animation', "Children's", 'Comedy',
               'Crime', 'Documentary', 'Drama', 'Fantasy', 'Film-Noir',
               'Horror', 'Musical', 'Mystery', 'Romance', 'Sci-Fi',
               'Thriller', 'War', 'Western']
_TITLE_WORDS = 5175


def movie_categories():
    return list(_CATEGORIES)


def get_movie_title_dict():
    return {('t%d' % i): i for i in range(_TITLE_WORDS)}


def max_user_id():
    return 6040


def max_movie_id():
    return 3952


def max_job_id():
    return 20


def _synthetic(n, tag):
    rng = common.synthetic_rng('movielens_' + tag)
    for _ in range(n):
        uid = int(rng.randint(1, 6041))
        gender = int(rng.randint(0, 2))
        age = int(rng.randint(0, 7))
        job = int(rng.randint(0, 21))
        mid = int(rng.randint(1, 3953))
        category = [int(rng.randint(0, len(_CATEGORIES)))]
        title = [int(rng.randint(0, _TITLE_WORDS)) for _ in range(3)]
        # learnable: the rating is a noisy user-movie affinity
        base = 1 + (uid * 7 + mid * 13 + gender * 3) % 5
        score = float(np.clip(base + rng.randint(-1, 2), 1, 5))
        yield [uid, gender, age, job, mid, category, title, score]


def train():
    def reader():
        for s in _synthetic(4096, 'train'):
            yield s
    return reader


def test():
    def reader():
        for s in _synthetic(512, 'test'):
            yield s
    return reader


class MovieInfo(object):
    """reference movielens.py:MovieInfo."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [CATEGORIES_DICT[c] for c in self.categories],
                [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return "<MovieInfo id(%d), title(%s), categories(%s)>" % (
            self.index, self.title, self.categories)


class UserInfo(object):
    """reference movielens.py:UserInfo."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return "<UserInfo id(%d), gender(%s), age(%d), job(%d)>" % (
            self.index, "M" if self.is_male else "F",
            age_table[self.age], self.job_id)


CATEGORIES_DICT = {c: i for i, c in enumerate(movie_categories())}
MOVIE_TITLE_DICT = get_movie_title_dict()


def movie_info():
    """id -> MovieInfo of the synthetic catalog (reference
    movielens.py:movie_info)."""
    rng = common.synthetic_rng('movielens_catalog')
    out = {}
    for mid in range(1, max_movie_id() + 1):
        cats = [_CATEGORIES[int(rng.randint(0, len(_CATEGORIES)))]]
        title = ' '.join('t%d' % int(t)
                         for t in rng.randint(0, _TITLE_WORDS, size=3))
        out[mid] = MovieInfo(mid, cats, title)
    return out


def user_info():
    """id -> UserInfo of the synthetic users (reference
    movielens.py:user_info)."""
    rng = common.synthetic_rng('movielens_users')
    out = {}
    for uid in range(1, max_user_id() + 1):
        out[uid] = UserInfo(uid, 'M' if rng.rand() < 0.5 else 'F',
                            age_table[int(rng.randint(0, len(age_table)))],
                            int(rng.randint(0, max_job_id() + 1)))
    return out

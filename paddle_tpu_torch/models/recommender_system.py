"""MovieLens recommender (Fluid book ch05).

Parity: reference python/paddle/fluid/tests/book/test_recommender_system.py
and the JAX package's models/recommender_system.py, op for op. The user
tower: id, gender, age and job embeddings, each through an fc, concatenated
into a 200-wide tanh fc. The movie tower: the id embedding through an fc,
the categories' embeddings sum-pooled, the title sequence through
sequence_conv_pool, concatenated into a 200-wide tanh fc. The head:
cos_sim scaled to [0, 5], square_error_cost against the score, SGD.

dist_axis (row-sharding the user, movie and title tables over a mesh
axis) needs the parallel slice of the port and raises
NotImplementedError; is_sparse=True trains the three big tables through
the touched-rows path.
"""
from .. import fluid
from ..batch import batch
from ..dataset import movielens
from ..fluid import layers, nets
from ..reader import shuffle

__all__ = ['model', 'get_model', 'FEED_ORDER']

FEED_ORDER = ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
              'category_id', 'movie_title', 'score']


def _no_dist(dist_axis):
    if dist_axis is not None:
        raise NotImplementedError(
            'recommender_system(dist_axis=...): row-sharded tables are not '
            'ported yet')


def get_usr_combined_features(emb_dim=32, out_dim=200, dist_axis=None,
                              axis_size=1, is_sparse=False):
    _no_dist(dist_axis)
    uid = layers.data(name='user_id', shape=[1], dtype='int64')
    usr_emb = layers.embedding(input=uid, dtype='float32',
                               size=[movielens.max_user_id() + 1, emb_dim],
                               is_sparse=is_sparse, is_distributed=False,
                               param_attr=fluid.ParamAttr(name='user_table'))
    usr_fc = layers.fc(input=usr_emb, size=emb_dim)

    usr_gender_id = layers.data(name='gender_id', shape=[1], dtype='int64')
    usr_gender_emb = layers.embedding(input=usr_gender_id, size=[2, 16],
                                      param_attr='gender_table')
    usr_gender_fc = layers.fc(input=usr_gender_emb, size=16)

    usr_age_id = layers.data(name='age_id', shape=[1], dtype='int64')
    usr_age_emb = layers.embedding(
        input=usr_age_id, size=[len(movielens.age_table), 16],
        param_attr='age_table')
    usr_age_fc = layers.fc(input=usr_age_emb, size=16)

    usr_job_id = layers.data(name='job_id', shape=[1], dtype='int64')
    usr_job_emb = layers.embedding(
        input=usr_job_id, size=[movielens.max_job_id() + 1, 16],
        param_attr='job_table')
    usr_job_fc = layers.fc(input=usr_job_emb, size=16)

    concat_embed = layers.concat(
        input=[usr_fc, usr_gender_fc, usr_age_fc, usr_job_fc], axis=1)
    return layers.fc(input=concat_embed, size=out_dim, act='tanh')


def get_mov_combined_features(emb_dim=32, out_dim=200, dist_axis=None,
                              axis_size=1, is_sparse=False):
    _no_dist(dist_axis)
    mov_id = layers.data(name='movie_id', shape=[1], dtype='int64')
    mov_emb = layers.embedding(
        input=mov_id, dtype='float32',
        size=[movielens.max_movie_id() + 1, emb_dim], is_sparse=is_sparse,
        is_distributed=False, param_attr=fluid.ParamAttr(name='movie_table'))
    mov_fc = layers.fc(input=mov_emb, size=emb_dim)

    category_id = layers.data(name='category_id', shape=[1], dtype='int64',
                              lod_level=1)
    mov_categories_emb = layers.embedding(
        input=category_id, size=[len(movielens.movie_categories()), emb_dim])
    mov_categories_hidden = layers.sequence_pool(
        input=mov_categories_emb, pool_type='sum')

    mov_title_id = layers.data(name='movie_title', shape=[1], dtype='int64',
                               lod_level=1)
    mov_title_emb = layers.embedding(
        input=mov_title_id,
        size=[len(movielens.get_movie_title_dict()), emb_dim],
        is_sparse=is_sparse, is_distributed=False,
        param_attr=fluid.ParamAttr(name='title_table'))
    mov_title_conv = nets.sequence_conv_pool(
        input=mov_title_emb, num_filters=emb_dim, filter_size=3, act='tanh',
        pool_type='sum')

    concat_embed = layers.concat(
        input=[mov_fc, mov_categories_hidden, mov_title_conv], axis=1)
    return layers.fc(input=concat_embed, size=out_dim, act='tanh')


def model(emb_dim=32, tower_dim=200, dist_axis=None, axis_size=1,
          is_sparse=False):
    """Both towers and the head. Returns (the scaled cosine [B, 1], the
    mean squared error)."""
    usr = get_usr_combined_features(emb_dim, tower_dim, dist_axis,
                                    axis_size, is_sparse)
    mov = get_mov_combined_features(emb_dim, tower_dim, dist_axis,
                                    axis_size, is_sparse)
    inference = layers.cos_sim(X=usr, Y=mov)
    scale_infer = layers.scale(x=inference, scale=5.0)

    label = layers.data(name='score', shape=[1], dtype='float32')
    avg_cost = layers.mean(
        layers.square_error_cost(input=scale_infer, label=label))
    return scale_infer, avg_cost


def get_model(batch_size=256, learning_rate=0.2, emb_dim=32, tower_dim=200):
    """In the default programs. Returns (avg_cost, scale_infer, the
    for_test program, train_reader, test_reader, FEED_ORDER)."""
    scale_infer, avg_cost = model(emb_dim, tower_dim)
    inference_program = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    train_reader = batch(shuffle(movielens.train(), buf_size=8192),
                         batch_size=batch_size)
    test_reader = batch(movielens.test(), batch_size=batch_size)
    return (avg_cost, scale_infer, inference_program, train_reader,
            test_reader, list(FEED_ORDER))

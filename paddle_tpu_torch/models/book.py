"""The book-chapter models (the port of ``paddle_tpu/models/book.py``):
fit_a_line, word2vec (an N-gram LM, dense or sparse), recommender_system
(MovieLens dual towers) and label_semantic_roles (stacked
alternating-direction LSTMs + a linear-chain CRF).

Each ``build_*`` builds the whole train graph in the current program and
returns (feed_names, loss, extra), as the other models do; the same
calls build the reference's program byte for byte.  Shapes follow the
book's configurations; vocabulary sizes are parameters so tests can
shrink them.  SRL's LSTMs are K6/K7's on the card where
``lstm_eligible`` passes (at the book's width, H = 128).
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def build_fit_a_line(feature_dim=13, lr=0.01):
    """test_fit_a_line.py: linear regression on UCI housing."""
    x = fluid.layers.data("x", [feature_dim])
    y = fluid.layers.data("y", [1])
    y_predict = fluid.layers.fc(x, 1)
    cost = fluid.layers.square_error_cost(y_predict, y)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return ["x", "y"], avg_cost, y_predict


def build_word2vec(dict_size=2000, embed_size=32, hidden_size=256,
                   is_sparse=False, lr=0.001):
    """test_word2vec.py: 4-gram neural LM with a shared embedding table."""
    words = []
    embeds = []
    for name in ("firstw", "secondw", "thirdw", "forthw"):
        w = fluid.layers.data(name, [1], dtype="int64")
        words.append(name)
        embeds.append(fluid.layers.embedding(
            w, size=[dict_size, embed_size], is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name="shared_w")))
    concat = fluid.layers.concat(embeds, axis=1)
    hidden1 = fluid.layers.fc(concat, hidden_size, act="sigmoid")
    predict = fluid.layers.fc(hidden1, dict_size, act="softmax")
    next_word = fluid.layers.data("nextw", [1], dtype="int64")
    cost = fluid.layers.cross_entropy(predict, next_word)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return words + ["nextw"], avg_cost, predict


def build_recommender(usr_dict=100, gender_dict=2, age_dict=7, job_dict=21,
                      mov_dict=200, category_dict=19, title_dict=500,
                      max_title_len=10, max_cat_len=4, is_sparse=False,
                      lr=0.2):
    """test_recommender_system.py: user/movie dual towers -> cos_sim ->
    square error on the rating."""
    def emb_fc(name, vocab, emb_dim, fc_dim, table):
        did = fluid.layers.data(name, [1], dtype="int64")
        e = fluid.layers.embedding(
            did, size=[vocab, emb_dim], is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name=table))
        return name, fluid.layers.fc(e, fc_dim)

    n1, usr_fc = emb_fc("user_id", usr_dict, 32, 32, "user_table")
    n2, gender_fc = emb_fc("gender_id", gender_dict, 16, 16, "gender_table")
    n3, age_fc = emb_fc("age_id", age_dict, 16, 16, "age_table")
    n4, job_fc = emb_fc("job_id", job_dict, 16, 16, "job_table")
    usr = fluid.layers.fc(
        fluid.layers.concat([usr_fc, gender_fc, age_fc, job_fc], axis=1),
        200, act="tanh")

    n5, mov_fc = emb_fc("movie_id", mov_dict, 32, 32, "movie_table")
    cat = fluid.layers.data("category_id", [1], dtype="int64", lod_level=1)
    cat_emb = fluid.layers.embedding(cat, size=[category_dict, 32],
                                     is_sparse=is_sparse)
    cat_pool = fluid.layers.sequence_pool(cat_emb, "sum")
    title = fluid.layers.data("movie_title", [1], dtype="int64",
                              lod_level=1)
    title_emb = fluid.layers.embedding(title, size=[title_dict, 32],
                                       is_sparse=is_sparse)
    title_conv = fluid.nets.sequence_conv_pool(
        title_emb, num_filters=32, filter_size=3, act="tanh",
        pool_type="sum")
    mov = fluid.layers.fc(
        fluid.layers.concat([mov_fc, cat_pool, title_conv], axis=1),
        200, act="tanh")

    inference = fluid.layers.cos_sim(usr, mov)
    scale_infer = fluid.layers.scale(inference, scale=5.0)
    label = fluid.layers.data("score", [1])
    cost = fluid.layers.square_error_cost(scale_infer, label)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    feeds = [n1, n2, n3, n4, n5, "category_id", "category_id@LEN",
             "movie_title", "movie_title@LEN", "score"]
    return feeds, avg_cost, scale_infer


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, pred_dict_len, mark_dict_len, label_dict_len,
            word_dim=32, mark_dim=5, hidden_dim=512, depth=8):
    """test_label_semantic_roles.py db_lstm: 8 stacked alternating-direction
    LSTMs over summed input projections."""
    predicate_embedding = fluid.layers.embedding(
        predicate, size=[pred_dict_len, word_dim],
        param_attr=fluid.ParamAttr(name="vemb"))
    mark_embedding = fluid.layers.embedding(
        mark, size=[mark_dict_len, mark_dim])
    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [
        fluid.layers.embedding(
            x, size=[word_dict_len, word_dim],
            param_attr=fluid.ParamAttr(name="emb", trainable=False))
        for x in word_input]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0_layers = [fluid.layers.fc(emb, hidden_dim, num_flatten_dims=2)
                       for emb in emb_layers]
    hidden_0 = fluid.layers.sums(hidden_0_layers)
    lstm_0, _ = fluid.layers.dynamic_lstm(hidden_0, hidden_dim)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = fluid.layers.sums([
            fluid.layers.fc(input_tmp[0], hidden_dim, num_flatten_dims=2),
            fluid.layers.fc(input_tmp[1], hidden_dim, num_flatten_dims=2)])
        lstm, _ = fluid.layers.dynamic_lstm(
            mix_hidden, hidden_dim, is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]
    feature_out = fluid.layers.sums([
        fluid.layers.fc(input_tmp[0], label_dict_len, act="tanh",
                        num_flatten_dims=2),
        fluid.layers.fc(input_tmp[1], label_dict_len, act="tanh",
                        num_flatten_dims=2)])
    return feature_out


def build_label_semantic_roles(word_dict=100, pred_dict=20, mark_dict=2,
                               label_dict=15, max_len=20, word_dim=16,
                               hidden_dim=32, depth=4, lr=0.01):
    """SRL train graph: db_lstm features -> linear_chain_crf loss +
    crf_decoding (the book config shrunk via the kwargs)."""
    names = ["word_data", "verb_data", "ctx_n2_data", "ctx_n1_data",
             "ctx_0_data", "ctx_p1_data", "ctx_p2_data", "mark_data"]
    datas = [fluid.layers.data(n, [1], dtype="int64", lod_level=1)
             for n in names]
    feature_out = db_lstm(*datas, word_dict_len=word_dict,
                          pred_dict_len=pred_dict, mark_dict_len=mark_dict,
                          label_dict_len=label_dict, word_dim=word_dim,
                          mark_dim=5, hidden_dim=hidden_dim, depth=depth)
    target = fluid.layers.data("target", [1], dtype="int64", lod_level=1)
    crf_cost = fluid.layers.linear_chain_crf(
        feature_out, target, param_attr=fluid.ParamAttr(name="crfw"))
    avg_cost = fluid.layers.mean(crf_cost)
    fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    decode = fluid.layers.crf_decoding(
        feature_out, param_attr=fluid.ParamAttr(name="crfw"))
    feeds = []
    for n in names:
        feeds += [n, n + "@LEN"]
    feeds += ["target", "target@LEN"]
    return feeds, avg_cost, decode

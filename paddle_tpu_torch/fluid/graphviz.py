"""Minimal dot-language builder used by net_drawer and debugger.

Parity: the JAX package's fluid/graphviz.py and the reference
python/paddle/fluid/graphviz.py (Graph / Node / Edge and the
GraphPreviewGenerator convenience layer). Pure string emission: rendering
to an image shells out to `dot` only if it is installed.
"""
import os
import subprocess

__all__ = ['Graph', 'Node', 'Edge', 'GraphPreviewGenerator']


def _attr_str(attrs):
    if not attrs:
        return ''
    return '[' + ', '.join('%s="%s"' % (k, v)
                           for k, v in sorted(attrs.items())) + ']'


class Node(object):
    counter = 0

    def __init__(self, label, prefix='node', **attrs):
        Node.counter += 1
        self.name = '%s_%d' % (prefix, Node.counter)
        self.label = label
        self.attrs = attrs

    def __str__(self):
        attrs = dict(self.attrs)
        attrs['label'] = self.label
        return '%s %s;' % (self.name, _attr_str(attrs))


class Edge(object):
    def __init__(self, source, target, **attrs):
        self.source = source
        self.target = target
        self.attrs = attrs

    def __str__(self):
        return '%s -> %s %s;' % (self.source.name, self.target.name,
                                 _attr_str(self.attrs))


class Graph(object):
    def __init__(self, title, **attrs):
        self.title = title
        self.attrs = attrs
        self.nodes = []
        self.edges = []

    def add_node(self, label, prefix='node', **attrs):
        node = Node(label, prefix=prefix, **attrs)
        self.nodes.append(node)
        return node

    def add_edge(self, source, target, **attrs):
        edge = Edge(source, target, **attrs)
        self.edges.append(edge)
        return edge

    def compile(self, dot_path):
        """Write the .dot file; returns the path of the image `dot` would
        produce next to it."""
        with open(dot_path, 'w') as f:
            f.write(str(self))
        return dot_path[:-4] + '.png' if dot_path.endswith('.dot') \
            else dot_path + '.png'

    def show(self, dot_path):
        """compile + best-effort render with graphviz `dot` if installed."""
        image = self.compile(dot_path)
        try:
            subprocess.run(['dot', '-Tpng', dot_path, '-o', image],
                           check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=60)
        except Exception:
            return None  # dot binary absent: the .dot file still exists
        return image

    def __str__(self):
        out = ['digraph G {']
        if self.title:
            out.append('  label="%s";' % self.title)
        out.extend('  %s="%s";' % (k, v) for k, v in sorted(self.attrs.items()))
        out.extend('  ' + str(n) for n in self.nodes)
        out.extend('  ' + str(e) for e in self.edges)
        out.append('}')
        return '\n'.join(out)


class GraphPreviewGenerator(object):
    """Convenience layer: parameters as ellipses, ops as rects, tmp vars
    dotted (reference graphviz.py:GraphPreviewGenerator)."""

    def __init__(self, title):
        self.graph = Graph(title, rankdir='TB')

    def add_param(self, name, data_type, highlight=False):
        label = '%s\\n%s' % (name, data_type)
        return self.graph.add_node(
            label, prefix='param', shape='ellipse', style='filled',
            fillcolor='lightcoral' if highlight else 'lightgrey')

    def add_op(self, opType, **kwargs):
        return self.graph.add_node(opType, prefix='op', shape='rect',
                                   style='rounded,filled',
                                   fillcolor='lightblue')

    def add_arg(self, name, highlight=False):
        return self.graph.add_node(
            name, prefix='arg', shape='box', style='dotted,filled',
            fillcolor='yellow' if highlight else 'white')

    def add_edge(self, source, target, **kwargs):
        return self.graph.add_edge(source, target, **kwargs)

    def __call__(self, path='temp.dot', show=False):
        if show:
            return self.graph.show(path)
        return self.graph.compile(path)
